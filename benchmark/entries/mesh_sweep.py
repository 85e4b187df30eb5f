"""The sweep window of ``entries/sweep.py`` over a mesh of processes, one
card each, as the port's README runs it under torchrun.

The process the benchmark starts is rank 0.  It starts the other ranks
(this same command with ``--rank r --rendezvous <file>``, their standard
output sent to standard error), every rank joins the process group on a
file rendezvous in ``TMPDIR`` and makes ``make_mesh()``, and each calls
``monte_carlo(..., mesh=mesh)`` sweep after sweep.  NCCL's shared-memory
transport is off (``NCCL_SHM_DISABLE=1``), so nothing is written to
``/dev/shm``; peer-to-peer over NVLink carries the all_gather.  Rank 0
waits for every rank it started to end.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch.distributed as dist

from benchmark import harness

_here = harness.load_module(harness.HERE / "entries" / "sweep.py",
                            "bench_entry_sweep_for_mesh")
check = _here.check
answers_of = _here.answers_of
reference_outputs = _here.reference_outputs
compare = _here.compare
WORKER_WAIT_S = 120


def run(ctx) -> dict:
    from robogame_tpu_torch.parallel.mesh import init_distributed, make_mesh
    world = ctx.chips
    os.environ["NCCL_SHM_DISABLE"] = "1"
    procs, path = [], ctx.rendezvous
    if path is None:
        fd, path = tempfile.mkstemp(prefix="bench_rendezvous_")
        os.close(fd)
        os.unlink(path)            # the file store makes it
        script = harness.HERE / "run.py"
        for r in range(1, world):
            env = dict(os.environ, LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), "--workload", ctx.workload,
                 "--seed", str(ctx.seed), "--seconds", str(ctx.seconds),
                 "--trace", str(int(ctx.trace)), "--rank", str(r),
                 "--rendezvous", path], env=env, stdout=sys.stderr))
    try:
        os.environ["LOCAL_RANK"] = str(ctx.rank)
        init_distributed(f"file://{path}", world, ctx.rank, ctx.device)
        ctx.mesh = make_mesh(world, device=ctx.device)
        ctx.world = world
        out = _here.run(ctx)
        dist.barrier()
        dist.destroy_process_group()
    finally:
        code = 0
        for p in procs:
            try:
                code = max(code, p.wait(timeout=WORKER_WAIT_S))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                code = max(code, 1)
        if procs and os.path.exists(path):
            os.unlink(path)
    if code:
        print(f"benchmark: a rank exited with {code}", file=sys.stderr)
    out["exit"] = code
    return out
