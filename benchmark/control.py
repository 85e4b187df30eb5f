"""The readings that a cell's limits are set from: the program's and the
control's, seed by seed, in one process.

    python3 benchmark/control.py --workload <cell> --seeds <n,n,...>
        --seconds <s> [--json <file>]

For each seed it runs the cell's window as the benchmark does (``--seconds``
long), then reads every number the cell compares twice: once for what the
program produced (the lower readings), once with the program's outputs
replaced by the plain reference's computed in bfloat16 from the same
inputs, the next precision below the configuration's float32 (the
control, the upper readings; a limit has to fail it).  One JSON line a
seed, then a summary line: each number's largest program reading and
smallest control reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, roofline  # noqa: E402

CONTROL_DTYPE = "bfloat16"


def readings(spec: dict, workload: str, seed: int, seconds: float,
             device=None, sizes=None) -> dict:
    """The program's and the control's readings of one seed's window.
    ``device`` and ``sizes`` (a function of the configuration and the mix
    returning smaller ones) are the CPU tests'."""
    import torch
    _, _, cfg, mix = harness.cell(spec, workload)
    if sizes is not None:
        cfg, mix = sizes(cfg, mix)
    w = next(w for w in spec["workloads"] if w["name"] == workload)
    entry = harness.load_module(
        harness.HERE / "entries" / f"{cfg['entry']}.py",
        "bench_entry_" + cfg["entry"])
    dev = device or torch.device("cuda", 0)
    ctx = SimpleNamespace(cfg=cfg, mix=mix, seed=seed, seconds=seconds,
                          trace=False, t_start=harness.now(), chips=w["chips"],
                          rank=0, rendezvous=None, workload=workload,
                          device=dev)
    run = entry.run(ctx)
    ans = entry.answers_of(run)
    prog, _ = entry.compare(ans, cfg, dev)
    low = getattr(torch, CONTROL_DTYPE)
    ctrl, _ = entry.compare(entry.reference_outputs(ans, cfg, dev, low), cfg,
                            dev)
    return {"seed": seed, "workload": workload,
            "program": {n: v for n, v, _ in prog},
            "control": {n: v for n, v, _ in ctrl},
            "limits": {n: lim for n, _, lim in prog}}


def summary(rows: list) -> dict:
    names = rows[0]["program"]
    return {"lower": {n: max(r["program"][n] for r in rows) for n in names},
            "upper": {n: min(r["control"][n] for r in rows) for n in names},
            "seeds": [r["seed"] for r in rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.bench_spec()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(spec, args.workload, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    out = summary(rows)
    out["card"] = roofline.power_limit()
    print(json.dumps(out), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps({"rows": rows, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
