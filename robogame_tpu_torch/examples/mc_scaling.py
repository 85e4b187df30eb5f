"""Monte-Carlo scaling sweep across a mesh of processes.

    python -m robogame_tpu_torch.examples.mc_scaling [--games-per-device
        1024] [--steps 100] [--engine sweep] [--cpu] [--virtual N]

Games/s with the batch sharded over 1, 2, 4, ... N processes of the
``"games"`` mesh (``parallel.mesh``), one card a process on NCCL (N: the
cards of this machine), and the scaling efficiency against one process.
Each size runs in processes of its own (one: this process), which meet
on a file rendezvous and run ``monte_carlo(mesh=make_mesh())`` once to
warm up and once timed (the processes synchronized before and after, with
a host fetch).
``--virtual N`` runs N Gloo processes on the CPU (the JAX driver's
virtual CPU devices): they share the host's cores, so the efficiency then
checks the sharded path, not the hardware's scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from . import add_cpu_flag, driver_device

PROG = "python -m robogame_tpu_torch.examples.mc_scaling"
# the directory that holds the package, where the workers start
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _workload(args, n: int):
    from ..config import SimParams
    from ..parallel.monte_carlo import McParams

    params = SimParams(dtype="float32", engine=args.engine)
    # ceil(T / dt) == steps
    mc = McParams(num_runs=args.games_per_device * n,
                  T=(args.steps - 0.5) * params.dt, randomize_x0=True)
    return params, mc


def run_worker(args) -> None:
    """One process of a size; rank 0 writes the size's rate to
    ``args.out``."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, make_mesh
    from ..parallel.monte_carlo import monte_carlo

    dev = torch.device("cpu" if args.cpu else "cuda")
    init_distributed(args.coordinator, args.nproc, args.process_id, dev)
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(device=dev)
        params, mc = _workload(args, args.nproc)
        monte_carlo(params, mc, mesh=mesh, device=dev).scores.cpu()
        dist.barrier()
        t0 = time.perf_counter()
        res = monte_carlo(params, mc, mesh=mesh, device=dev)
        res.scores.cpu()
        dist.barrier()
        wall = time.perf_counter() - t0
        if dist.get_rank() == 0:
            with open(args.out, "w") as f:
                json.dump({"wall": wall, "games": mc.num_runs}, f)
    finally:
        dist.destroy_process_group()


def _tmp(suffix: str) -> str:
    fd, path = tempfile.mkstemp(prefix="mc_scaling_", suffix=suffix)
    os.close(fd)
    return path


def run_size(args, n: int) -> float:
    """Control-steps/s of the sweep over ``n`` processes (at one, this
    process is the one worker)."""
    out, store = _tmp(".json"), _tmp(".store")
    worker = dict(vars(args), nproc=n, out=out, process_id=0,
                  coordinator=f"file://{store}")
    cmd = [sys.executable, "-m", "robogame_tpu_torch.examples.mc_scaling",
           "--nproc", str(n), "--out", out, "--coordinator",
           f"file://{store}", "--games-per-device",
           str(args.games_per_device), "--steps", str(args.steps),
           "--engine", args.engine] + (["--cpu"] if args.cpu else [])
    env = dict(os.environ, OMP_NUM_THREADS="1") if args.cpu else None
    procs = []
    try:
        if n == 1:
            run_worker(argparse.Namespace(**worker))
        else:
            for pid in range(n):
                procs.append(subprocess.Popen(
                    cmd + ["--process-id", str(pid)], cwd=_ROOT, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            logs = [p.communicate(timeout=900)[0] for p in procs]
            if any(p.returncode for p in procs):
                for i, (p, log) in enumerate(zip(procs, logs)):
                    print(f"--- worker {i} (rc={p.returncode}) ---")
                    print(log.decode(errors="replace")[-4000:])
                raise RuntimeError(f"mc_scaling: a worker of {n} failed")
        with open(out) as f:
            rec = json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in (out, store):
            if os.path.exists(path):
                os.unlink(path)
    return rec["games"] * args.steps / rec["wall"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="N Gloo processes on the CPU")
    ap.add_argument("--games-per-device", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--engine", default="sweep", choices=["sweep", "pallas"])
    add_cpu_flag(ap)
    ap.add_argument("--nproc", type=int, default=None,
                    help="internal: a worker's process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="internal: run as worker N")
    ap.add_argument("--coordinator", default=None,
                    help="internal: the workers' rendezvous")
    ap.add_argument("--out", default=None, help="internal: rank 0's output")
    args = ap.parse_args(argv)
    if args.process_id is not None:
        run_worker(args)
        return 0
    args.cpu = args.cpu or args.virtual > 0
    dev = driver_device(args, PROG)
    n_dev = (args.virtual or 1) if dev.type == "cpu" \
        else torch.cuda.device_count()
    if args.virtual:
        print("NOTE: the Gloo processes share this host's cores -- the "
              "efficiency here checks the sharded path, not the "
              "hardware's scaling")
    sizes, d = [], 1
    while d <= n_dev:
        sizes.append(d)
        d *= 2
    if sizes[-1] != n_dev:
        sizes.append(n_dev)
    results = {}
    for nd in sizes:
        rate = run_size(args, nd)
        results[nd] = rate
        eff = rate / (results[sizes[0]] * nd / sizes[0])
        print(f"devices={nd:3d}  B={args.games_per_device * nd:6d}  "
              f"steps/s={rate:12,.0f}  scaling_eff={eff:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
