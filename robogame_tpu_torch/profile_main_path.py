"""Where the main path's time goes on the card.

    python -m robogame_tpu_torch.profile_main_path

Runs the bench workload (8192 games, per-game U(-8, 8) schedules held 10
steps, winning_score=4, two-phase exact step) for 200 control steps, then
traces 40 more with ``torch.profiler`` and prints the wall time per step,
the device time per kernel name and the device's busy share of the traced
wall time.  Needs a CUDA device.
"""

from __future__ import annotations

import importlib
import subprocess
import time

import torch

B, HOLD, STEPS = 8192, 10, 40


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: no CUDA device")
    import robogame_tpu_torch as rt
    mc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    p = rt.SimParams(engine="pallas_exact", winning_score=4, two_phase=True,
                     phase1_iters=1, compact_frac=16)
    g = torch.Generator().manual_seed(0)
    n_rows = (200 + STEPS) // HOLD + 1
    u = (torch.rand((n_rows, B, 4, 2), generator=g) * 16.0 - 8.0).to(dev)

    def schedule(ps, states):
        k, u_base = ps
        return (k + 1, u_base), u_base[k // HOLD]

    s = mc._initial_states(p, rt.McParams(num_runs=B, randomize_x0=True),
                           device=dev)
    s, ps = mc._run_batch(s, p, 200, schedule, (0, u), device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s, ps = mc._run_batch(s, p, STEPS, schedule, ps, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                ev.device_time_total > 0:
            rows.append((ev.device_time_total, ev.key, ev.count))
    busy_us = sum(r[0] for r in rows)
    print(f"card: {card}")
    print(f"B={B}, steps 200..{200 + STEPS}: {wall / STEPS * 1e3:.4f}"
          f" ms wall per step (traced)")
    if not rows:
        print("device time: not measured (the trace holds no device events)")
        return
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall: "
          f"{busy_us / (wall * 1e6):.4f}")
    for dev_us, key, count in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / STEPS:10.2f} us/step  {count:6d} launches  "
              f"{key[:90]}")


if __name__ == "__main__":
    main()
