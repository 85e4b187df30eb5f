"""A Monte-Carlo sweep sharded over several processes through
``torch.distributed``, held against the same sweep in one process.

    python -m robogame_tpu_torch.distributed_mc [--nproc 2] [--games 64]
        [--steps 20] [--sweep-iters 50] [--device cuda|cpu]

The parent spawns ``--nproc`` worker processes on this machine.  They
meet on a file rendezvous (a new file from ``mkstemp``, so no port is
taken), build the mesh of :mod:`.parallel.mesh` (Gloo on the CPU, NCCL
with one card a process) and run :func:`.parallel.monte_carlo.sweep` on
it: each rank steps its slice of the games, and the final states are
all-gathered.  The parent then runs the same workload in one process and
compares: scores exact, damage within 1e-5, positions within 1e-4, the
statistics (goals, total damage, mean player x) within 1e-4 relative.  It
prints one JSON line with ``"ok"`` and exits 0 when all hold.

The workload: the sweep engine in f32, seeds 1..G with randomized pucks,
and head-on schedules (team A driving +x, team B -x, a per-player y drive
from seed 20260820), so the games collide and the damage is not zero.

With torchrun, a script calls ``make_mesh()`` instead, which joins the
``env://`` rendezvous that torchrun sets up.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SCHEDULE_SEED = 20260820
# the directory that holds the package, where the workers start
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _schedule_policy(ps, states):
    k, sched = ps
    return (k + 1, sched), sched[:, k]


def _workload(games: int, steps: int, sweep_iters: int, device):
    """(params, McParams, policy state): the schedule is batch-leading,
    (G, steps, 4, 2), so a mesh pads and slices it with the games."""
    from .config import SimParams
    from .parallel.monte_carlo import McParams

    params = SimParams(dtype="float32", engine="sweep",
                       sweep_iters=sweep_iters)
    # ceil(T / dt) == steps
    mc = McParams(num_runs=games, T=(steps - 0.5) * params.dt,
                  randomize_x0=True)
    rng = np.random.default_rng(SCHEDULE_SEED)
    sched = np.zeros((steps, games, 4, 2), np.float32)
    sched[:, :, 0:2, 0] = 8.0
    sched[:, :, 2:4, 0] = -8.0
    sched[:, :, :, 1] = rng.uniform(-2, 2, (1, games, 4))
    sched = torch.from_numpy(sched.transpose(1, 0, 2, 3).copy()).to(device)
    return params, mc, (0, sched)


def _stats(final) -> dict:
    return dict(goals=float(final.score.sum()),
                damage_total=float(final.damage.sum()),
                mean_px=float(final.x[:, :4, 0].mean()))


def _sweep(args, mesh=None):
    from .parallel.monte_carlo import sweep

    dev = torch.device(args.device)
    params, mc, ps = _workload(args.games, args.steps, args.sweep_iters, dev)
    final, _ = sweep(params, mc, _schedule_policy, ps, mesh=mesh,
                     device=dev)
    return final


def run_worker(args) -> None:
    """One process of the sharded run; rank 0 writes the gathered final
    state to ``args.out``."""
    import torch.distributed as dist

    from .parallel.mesh import init_distributed, make_mesh

    init_distributed(args.coordinator, args.nproc, args.process_id,
                     args.device)
    try:
        mesh = make_mesh(device=args.device)
        if mesh.size() != args.nproc:
            raise RuntimeError(f"mesh of {mesh.size()}, not {args.nproc}")
        final = _sweep(args, mesh)
        if dist.get_rank() == 0:
            np.savez(args.out, x=final.x.cpu().numpy(),
                     score=final.score.cpu().numpy(),
                     damage=final.damage.cpu().numpy(),
                     stats=np.asarray(list(_stats(final).values())))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tmp(suffix: str) -> str:
    fd, path = tempfile.mkstemp(prefix="distmc_", suffix=suffix)
    os.close(fd)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m robogame_tpu_torch.distributed_mc",
        description="A sweep sharded over processes, one device each (the "
        "JAX tool's --devices-per-proc has no counterpart: a process "
        "drives one card, or the CPU), against the same sweep in one "
        "process.")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--sweep-iters", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card a process; the default) or "
                    "cpu (Gloo)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="internal: run as worker N")
    ap.add_argument("--coordinator", default=None,
                    help="internal: the workers' rendezvous")
    ap.add_argument("--out", default=None, help="internal: rank 0's output")
    args = ap.parse_args(argv)

    if args.process_id is not None:
        run_worker(args)
        return 0
    if args.device.startswith("cuda") and \
            args.nproc > torch.cuda.device_count():
        raise SystemExit(f"--device cuda needs one card a process: "
                         f"{args.nproc} processes, "
                         f"{torch.cuda.device_count()} cards")

    out, store = _tmp(".npz"), _tmp(".store")
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in range(args.nproc):
            cmd = [sys.executable, "-m", "robogame_tpu_torch.distributed_mc",
                   "--process-id", str(pid), "--out", out,
                   "--coordinator", f"file://{store}",
                   "--nproc", str(args.nproc), "--games", str(args.games),
                   "--steps", str(args.steps),
                   "--sweep-iters", str(args.sweep_iters),
                   "--device", args.device]
            procs.append(subprocess.Popen(
                cmd, cwd=_ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=600)[0] for p in procs]
        rcs = [p.returncode for p in procs]
        t_dist = time.perf_counter() - t0
        if any(rcs):
            for i, log in enumerate(logs):
                print(f"--- worker {i} (rc={rcs[i]}) ---")
                print(log.decode(errors="replace")[-4000:])
            print(json.dumps({"ok": False, "rcs": rcs}))
            return 1
        with np.load(out) as z:
            got = {k: z[k] for k in z.files}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in (out, store):
            if os.path.exists(path):
                os.unlink(path)

    ref = _sweep(args)
    stats_ref = _stats(ref)
    stats_dist = dict(zip(stats_ref, map(float, got["stats"])))
    score_exact = bool(np.array_equal(got["score"], ref.score.cpu().numpy()))
    dmg_ok = bool(np.allclose(got["damage"], ref.damage.cpu().numpy(),
                              rtol=1e-5, atol=1e-5))
    x_ok = bool(np.allclose(got["x"], ref.x.cpu().numpy(), rtol=1e-4,
                            atol=1e-4))
    stats_ok = all(abs(stats_dist[k] - v) <= 1e-4 * max(1.0, abs(v))
                   for k, v in stats_ref.items())
    ok = score_exact and dmg_ok and x_ok and stats_ok
    print(json.dumps({
        "ok": ok, "nproc": args.nproc, "devices_per_proc": 1,
        "global_devices": args.nproc, "device": args.device,
        "games": args.games, "steps": args.steps,
        "score_exact": score_exact, "damage_close": dmg_ok,
        "x_close": x_ok, "stats_close": stats_ok,
        "stats": stats_dist, "t_distributed_s": round(t_dist, 1),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
