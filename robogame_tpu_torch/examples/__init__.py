"""The example drivers on the port, one module each, the JAX package's
``examples/`` on PyTorch and CUDA:

    python -m robogame_tpu_torch.examples.<name> [arguments] [--cpu]

=====================  ==================================================
run_collisions         replay A1.txt..B2.txt (or a built-in schedule)
                       through the event engine and log it
run_sim                classical vs classical behind the CBF filter, one
                       game through ``GameSim``
bounce_kick_demo       the bank shot off a wall into the goal
run_dmpc_sim           DMPC vs DMPC, one game
run_centralized_sim    CMPC vs CMPC, one game
visualize_game         animate a binary game log
mc_example_1 / _2      classical Monte-Carlo with / without the CBF filter,
                       a configuration.txt and a log a game
matchups               the reference's six matchups as batched sweeps, with
                       their qualitative invariants
bench_sweep            the physics sweep's control-steps/s at B 256, 2048,
                       8192 on K1 and K6, and the stochastic rows
bench_mpc              DMPC solves/s, closed-loop games/s, one game's
                       per-step latency
mc_scaling             a sweep over 1, 2, 4 ... processes of a mesh
train_es               evolution strategies training an attacker policy,
                       every candidate on its own game of one batch
=====================  ==================================================

Every driver has a ``main(argv=None)`` that returns the exit code, runs on
the card, and runs on the CPU (the kernels' plain versions) only when it
is given ``--cpu``: without a card and without ``--cpu`` it exits
non-zero.  They import nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import time

import torch


def add_cpu_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch "
                    "versions); without it the driver needs a CUDA device")


def driver_device(args, prog: str) -> torch.device:
    """The device a driver runs on: the CPU when asked with ``--cpu``,
    else the card; exits non-zero when there is none."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device is available; pass --cpu "
                         "to run the plain PyTorch path on the CPU")
    return torch.device("cuda")


def host(a):
    """A numpy copy of a tensor on any device."""
    return a.detach().cpu().numpy()


def time_call(fn, dev: torch.device):
    """(seconds, ``fn()``): CUDA events around the call on the card, the
    host clock on the CPU; the region ends with a host fetch of the
    result's first tensor (of a GameState, x)."""
    cuda = dev.type == "cuda"
    if cuda:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        ev1.record()
    first = out
    while isinstance(first, (tuple, list)):
        first = first[0]
    float(host(first).sum())
    if cuda:
        return ev0.elapsed_time(ev1) / 1e3, out
    return time.perf_counter() - t0, out


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
