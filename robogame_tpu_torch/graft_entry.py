"""The port's entry points for a harness:

* :func:`entry` -> ``(fn, example_args)``: one batched control step of the
  sweep engine over 256 games (``fn(states, controls)``);
* :func:`dryrun_multichip` -> runs the real policy-in-the-loop step on a
  mesh of ``n`` processes, one card each (NCCL; Gloo when asked for the
  CPU), at tiny shapes: both classical teams' ``team_policy_batch``, the
  CBF filter ``safe_control_batch``, the physics and the cross-game mean
  through ``dist.all_reduce``; then ``monte_carlo`` on the mesh on K6,
  stochastic on K1, and a DMPC team step (K3) with the physics.

    python -m robogame_tpu_torch.graft_entry [--nproc 2] [--cpu]

The processes of a dry run (at n = 1, this process) meet on a file
rendezvous; each takes its slice of B = 2 n games (``shard_batch``), so
every rank launches its own kernels.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

# the directory that holds the package, where the workers start
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROG = "python -m robogame_tpu_torch.graft_entry"


def entry(device="cuda"):
    """``(fn, (states, controls))``: ``fn`` is one control step of the
    sweep engine over a batch of 256 games with random pucks."""
    from .config import SimParams
    from .parallel.monte_carlo import McParams, _initial_states
    from .physics.step import step_batch

    params = SimParams(dtype="float32", engine="sweep")
    B = 256
    states = _initial_states(params, McParams(num_runs=B, randomize_x0=True),
                             device=device)
    controls = torch.zeros((B, 4, 2), dtype=torch.float32,
                           device=states.x.device)

    def fn(states, controls):
        return step_batch(states, controls, params, device=states.x.device)

    return fn, (states, controls)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_rank(device) -> None:
    """The dry run's work in one process of the mesh (its process group
    in place)."""
    import torch.distributed as dist

    from .agents.classical import initial_team_state, team_policy_batch
    from .agents.dmpc_team import initial_team_state as dmpc_init
    from .agents.dmpc_team import team_step_batch
    from .config import CbfParams, MpcParams, SimParams, StrategyParams
    from .control.cbf import safe_control_batch
    from .parallel.mesh import BATCH_AXIS, make_mesh, shard_batch
    from .parallel.monte_carlo import McParams, _initial_states, monte_carlo
    from .physics.step import step_batch

    dev = torch.device(device)
    mesh = make_mesh(device=dev)
    n = mesh.size()
    params = SimParams(dtype="float32", grid_points=10,   # tiny shapes
                       engine="sweep", sweep_iters=4)
    B = 2 * n
    states = shard_batch(_initial_states(
        params, McParams(num_runs=B, randomize_x0=True), device=dev), mesh)
    b = states.x.shape[0]
    strat = StrategyParams()
    cbf = CbfParams(qp_iters=8)
    ts_a = initial_team_state(b, torch.float32, dev)
    ts_b = initial_team_state(b, torch.float32, dev)

    # the policy-in-the-loop step: both teams' classical strategy (skill
    # solvers inside), the centralized CBF filter, physics, and the
    # cross-game statistics reduced over the mesh
    ts_a, u_a = team_policy_batch(ts_a, states.x, -1, params, strat)
    ts_b, u_b = team_policy_batch(ts_b, states.x, 1, params, strat)
    u = torch.cat([u_a, u_b], dim=1)
    u = safe_control_batch(u, states.x[:, :4, 0:2], states.x[:, :4, 2:4],
                           params, cbf).u
    s2 = step_batch(states, u, params, device=dev)
    stats = s2.x[:, :, :2].sum(0)
    dist.all_reduce(stats, group=mesh.get_group(BATCH_AXIS))
    stats = stats / B
    _check(s2.x.shape == (b, 5, 4) and stats.shape == (5, 2)
           and bool(torch.isfinite(stats).all()), "the classical step")

    # the kernel per rank: K6 on each rank's slice, and K1 stochastic
    # (every rank draws its own games' noise)
    mc = McParams(num_runs=B, T=2 * params.dt, randomize_x0=True)
    res = monte_carlo(params.replace(engine="pallas"), mc, mesh=mesh,
                      device=dev)
    _check(res.scores.shape == (B, 2), "monte_carlo on K6")
    res_s = monte_carlo(params.replace(engine="pallas_exact",
                                       stochastic=True, noise=0.5), mc,
                        mesh=mesh, device=dev)
    _check(res_s.scores.shape == (B, 2), "monte_carlo on K1, stochastic")

    # the DMPC team step over the same slices, closed with the physics
    # (N=4: K3 takes n1 = 2N a multiple of 8, where the JAX dry run has
    # N=6)
    mpc = MpcParams(N=4, sqp_iters=1, qp_iters=12, t_grid=2, t_local=1)
    da = dmpc_init(mpc, torch.float32, dev, (b,))
    db = dmpc_init(mpc, torch.float32, dev, (b,))
    da, u_a = team_step_batch(da, states.x, -1, params, mpc, strat)
    db, u_b = team_step_batch(db, states.x, 1, params, mpc, strat)
    s3 = step_batch(states, torch.cat([u_a, u_b], dim=1), params,
                    device=dev)
    puck = s3.x[:, 4, :2].sum(0)
    dist.all_reduce(puck, group=mesh.get_group(BATCH_AXIS))
    _check(s3.x.shape == (b, 5, 4) and bool(torch.isfinite(puck).all()),
           "the DMPC step")


def _worker(args) -> None:
    import torch.distributed as dist

    from .parallel.mesh import init_distributed

    device = "cpu" if args.cpu else "cuda"
    init_distributed(args.coordinator, args.nproc, args.process_id, device)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device("cpu"))
        _dryrun_rank(dev)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The dry run on ``n_devices`` processes of this machine, one card
    each (or Gloo processes on the CPU with ``device="cpu"``); raises if a
    process fails."""
    dev = torch.device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip: {n_devices} processes need "
                           f"as many cards, this machine has "
                           f"{torch.cuda.device_count()}")
    fd, store = tempfile.mkstemp(prefix="graft_entry_")
    os.close(fd)
    if n_devices == 1:                  # this process is the one process
        try:
            _worker(argparse.Namespace(
                cpu=dev.type == "cpu", nproc=1, process_id=0,
                coordinator=f"file://{store}"))
        finally:
            if os.path.exists(store):
                os.unlink(store)
        return
    cmd = [sys.executable, "-m", "robogame_tpu_torch.graft_entry",
           "--nproc", str(n_devices), "--coordinator", f"file://{store}"]
    cmd += ["--cpu"] if dev.type == "cpu" else []
    env = dict(os.environ, OMP_NUM_THREADS="1") if dev.type == "cpu" \
        else None
    procs = []
    try:
        for pid in range(n_devices):
            procs.append(subprocess.Popen(
                cmd + ["--process-id", str(pid)], cwd=_ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if os.path.exists(store):       # the store removes itself when done
            os.unlink(store)
    failed = [i for i, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError("dryrun_multichip: process(es) " + ", ".join(
            f"{i} (rc={procs[i].returncode}):\n"
            f"{logs[i].decode(errors='replace')[-3000:]}" for i in failed))


def main(argv=None) -> int:
    from .examples import add_cpu_flag, driver_device

    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2,
                    help="processes of the dry run, one card each")
    add_cpu_flag(ap)
    ap.add_argument("--process-id", type=int, default=None,
                    help="internal: run as process N of the dry run")
    ap.add_argument("--coordinator", default=None,
                    help="internal: the processes' rendezvous")
    args = ap.parse_args(argv)
    if args.process_id is not None:
        _worker(args)
        return 0
    dev = driver_device(args, PROG)
    fn, ex_args = entry(dev)
    out = fn(*ex_args)
    print("entry ok:", tuple(out.x.shape))
    dryrun_multichip(args.nproc, dev)
    print(f"dryrun ok: {args.nproc} processes on {dev.type}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
