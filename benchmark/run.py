"""The benchmark of the PyTorch/CUDA port: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Finds the cell in ``BENCHMARK.json``, drives the program through the
cell's entry (``entries/``) for a window of ``--seconds``, reads the
cell's metrics (end to end untraced, per layer with ``--trace 1``), holds
what the window produced against the plain reference, and prints one JSON
line last on standard output.  Exits non-zero, printing no result, without
as many CUDA devices as the cell asks for.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a worker process of a cell over several cards (entries/mesh_sweep.py)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = harness.process_start()
    args = parse(argv)
    harness.use_checkout_caches()
    spec = harness.bench_spec()
    w, _, cfg, mix = harness.cell(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {w['chips']} CUDA "
              f"device(s), found {found}", file=sys.stderr)
        return 2
    torch.cuda.init()
    harness.note(f"set-up: torch and the CUDA context at "
                 f"{harness.now() - t_start:.2f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = SimpleNamespace(cfg=cfg, mix=mix, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          t_start=t_start, chips=w["chips"], rank=args.rank,
                          rendezvous=args.rendezvous, workload=args.workload)
    return run_cell(spec, ctx)


def run_cell(spec: dict, ctx, device=None) -> int:
    """Drive the cell's entry, read its metrics, check it, print the
    result (rank 0 only).  ``device``: the tests' CPU in place of the
    card."""
    import torch
    entry = harness.load_module(
        harness.HERE / "entries" / f"{ctx.cfg['entry']}.py",
        "bench_entry_" + ctx.cfg["entry"])
    ctx.device = device or torch.device("cuda", ctx.rank)
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
    run = entry.run(ctx)
    if ctx.rank != 0:
        return run.get("exit", 0)
    cuda = ctx.device.type == "cuda"
    run["device"] = harness.device_info(ctx.chips, run["peak"], cuda)
    metrics = harness.read_metrics(
        harness.metrics_for(spec, ctx.workload, ctx.trace), run)
    if ctx.trace and cuda:
        from benchmark import roofline
        harness.note(f"rooflines against {roofline.H100_BYTES_PER_S:.3g} B/s "
                     f"and {roofline.H100_F32_PER_S:.3g} f32 FLOP/s at 700 W; "
                     f"this card: {roofline.power_limit()}")
    t0 = time.perf_counter()
    checks, bad = entry.check(run, ctx.cfg, ctx.device)
    print(f"benchmark: the reference took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    run["failed"] = bad
    code = harness.finish(run, checks, metrics, ctx.trace)
    return max(code, run.get("exit", 0))


if __name__ == "__main__":
    sys.exit(main())
