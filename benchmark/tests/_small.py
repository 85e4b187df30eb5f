"""Small versions of the cells for the CPU tests: the configurations and
mixes of ``BENCHMARK.json`` with a few games, a few steps and a small
sample, driven through the same entries on the CPU (the plain versions of
the program's kernels)."""

from __future__ import annotations

import copy
import json
import time
from types import SimpleNamespace

import torch

from benchmark import harness

SWEEP = "mc_exact_sweep.uniform_b32768"
CORNER = "mc_exact_sweep.corner_b32768"
MATCHUP = "matchup_dmpc_cmpc.b512"
MESH = "mc_exact_sweep_mesh4.uniform_4x8192"


def sizes(cfg: dict, mix: dict, T: float = 0.3):
    """A few games and ``T`` seconds of a cell's configuration and mix."""
    cfg, mix = copy.deepcopy(cfg), dict(mix)
    if cfg["entry"] == "matchup":
        cfg["McParams"]["T"] = 0.1        # 2 steps: a window of one step
        # still completes its kept pair (k = 0)
        cfg["sample"] = {"pairs": 1}
        mix["games"] = 4
    else:
        cfg["McParams"]["T"] = T
        cfg["sample"] = {"games": 4, "pairs": 1}
        mix["games"] = 16
    return cfg, mix


def run(workload: str, seed: int = 12345, seconds: float = 0.5,
        trace: bool = False, capsys=None, rank: int = 0, chips: int = 1,
        rendezvous=None, T: float = 0.3):
    """Drive a small cell on the CPU through ``run.run_cell``; returns the
    exit code and, on rank 0 with ``capsys``, the result line."""
    from benchmark.run import run_cell
    torch.set_num_threads(1)          # several test workers share the host
    spec = harness.bench_spec()
    _, _, cfg, mix = harness.cell(spec, workload)
    cfg, mix = sizes(cfg, mix, T)
    ctx = SimpleNamespace(cfg=cfg, mix=mix, seed=seed, seconds=seconds,
                          trace=trace, t_start=harness.now(), chips=chips,
                          rank=rank, rendezvous=rendezvous,
                          workload=workload)
    code = run_cell(spec, ctx, device=torch.device("cpu"))
    if capsys is None:
        return code, None
    lines = capsys.readouterr().out.strip().splitlines()
    return code, json.loads(lines[-1]) if lines else None
