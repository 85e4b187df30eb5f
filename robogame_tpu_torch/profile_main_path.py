"""Where a main path's time goes on the card.

    python -m robogame_tpu_torch.profile_main_path \
        [--path bench|classical_cbf|dmpc|cmpc|pallas|pallas_stoch|
                exact_stoch|event|event_golden]

``bench`` (slice 1): the bench workload (8192 games, per-game U(-8, 8)
schedules held 10 steps, winning_score=4, two-phase exact step) for 200
control steps, then 40 more traced.

``classical_cbf`` (slice 2): the classical vs classical matchup behind the
CBF filter (512 games, randomized puck starts) for 100 control steps, then
20 more traced.

``dmpc`` (slice 3): the DMPC vs DMPC matchup (512 games, randomized puck
starts, ``MpcParams()``) for 100 control steps, then 20 more traced.

``cmpc`` (slice 4): the CMPC vs CMPC matchup (cmpc_vs_cmpc: 512 games,
randomized puck starts, ``MpcParams()``) for 100 control steps, then 20
more traced.

``pallas`` (slice 5): the bench workload on the parallel-resolution step
(``engine="pallas"``, two-phase on K6) for 200 control steps, then 40
more traced.

``pallas_stoch`` and ``exact_stoch`` (slice 10): the stochastic rows,
the bench workload at 2048 games with ``noise=1.0`` on
``engine="pallas"`` (K6) and ``"pallas_exact"`` (K1), each game's noise
drawn on the card by the draw kernel (``csrc/game_noise.cu``), for 200
control steps, then 40 more traced.

``event`` (slice 9): the bench workload on the event engine
(``engine="event"``, plain PyTorch) for 10 control steps, then 10 more
traced.  ``event_golden``: one game in f64 on the golden kick_goal_10s
schedule (tests/golden/), whose players grind along the walls, for 135
control steps, then 2 more traced (49 loop iterations each).

Each traces with ``torch.profiler`` and prints the wall time per step, the
device time per kernel name, the device's busy share of the traced wall
time, and a split into K1, K2 (the skills on the grouped route: its
setup, its iterations and the per-problem kernel's launch over the
equality-row problems; the CBF QPs on the per-problem kernel, whose
template argument is its rows per lane, 1 for the CBF's 20), K3, K4, K5,
K6, the draw kernel and the glue kernels.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import time

import torch

B, HOLD, STEPS = 8192, 10, 40
B_STOCH = 2048                     # the stochastic rows
B_CL, WARM_CL, STEPS_CL = 512, 100, 20
# kernel-name fragments of the split (a kernel counts in the first group
# whose fragment its name holds)
GROUPS = (("K1 exact_step", "exact_step_kernel"),
          ("K2 skills, grouped setup", "grouped_setup_kernel"),
          ("K2 skills, grouped iterations (n=30, m=60)",
           "grouped_admm_kernel"),
          ("K2 skills, per-problem over equality rows",
           "qp_admm_listed_kernel"),
          ("K2 CBF (n=8, m=20)", "qp_admm_kernel<1>"),
          ("K3 DMPC SQP (n1=40, m_own=100)", "dmpc_sqp_kernel"),
          ("K4 CMPC SQP (n1=40, m_own=80, m_pair=20)", "cmpc_sqp_kernel"),
          ("K5 joint QP", "qp_joint_kernel"),
          ("K6 parallel_step", "parallel_step"),
          ("draws (game_noise)", "game_normals_kernel"))


def _bench(rt, mc, dev, engine="pallas_exact", warm=200, steps=STEPS,
           n_games=B, **noise):
    p = rt.SimParams(engine=engine, winning_score=4, two_phase=True,
                     phase1_iters=1, compact_frac=16, **noise)
    g = torch.Generator().manual_seed(0)
    n_rows = (warm + steps) // HOLD + 1
    u = (torch.rand((n_rows, n_games, 4, 2), generator=g) * 16.0
         - 8.0).to(dev)

    def schedule(ps, states):
        k, u_base = ps
        return (k + 1, u_base), u_base[k // HOLD]

    s = mc._initial_states(p, rt.McParams(num_runs=n_games,
                                          randomize_x0=True), device=dev)
    s, ps = mc._run_batch(s, p, warm, schedule, (0, u), device=dev)
    return p, schedule, s, ps, n_games, warm, steps


def _classical_cbf(rt, mc, dev):
    p = rt.SimParams(dt=0.05, winning_score=4, engine="pallas_exact")
    policy, ps = rt.classical_matchup(p, B_CL, cbf=rt.CbfParams(),
                                      device=dev)
    s = mc._initial_states(p, rt.McParams(
        num_runs=B_CL, randomize_x0=True, x0_pos_range=(1.0, 0.5),
        x0_vel_range=2.0), device=dev)
    s, ps = mc._run_batch(s, p, WARM_CL, policy, ps, device=dev)
    return p, policy, s, ps, B_CL, WARM_CL, STEPS_CL


def _dmpc(rt, mc, dev):
    from robogame_tpu_torch.agents.dmpc_team import dmpc_matchup
    p = rt.SimParams(dt=0.05, winning_score=4, engine="pallas_exact")
    policy, ps = dmpc_matchup(p, B_CL, "dmpc", device=dev)
    s = mc._initial_states(p, rt.McParams(
        num_runs=B_CL, randomize_x0=True, x0_pos_range=(1.0, 0.5),
        x0_vel_range=2.0), device=dev)
    s, ps = mc._run_batch(s, p, WARM_CL, policy, ps, device=dev)
    return p, policy, s, ps, B_CL, WARM_CL, STEPS_CL


def _cmpc(rt, mc, dev):
    p = rt.SimParams(dt=0.05, winning_score=4, engine="pallas_exact")
    policy, ps = rt.cmpc_matchup(p, B_CL, device=dev)
    s = mc._initial_states(p, rt.McParams(
        num_runs=B_CL, randomize_x0=True, x0_pos_range=(1.0, 0.5),
        x0_vel_range=2.0), device=dev)
    s, ps = mc._run_batch(s, p, WARM_CL, policy, ps, device=dev)
    return p, policy, s, ps, B_CL, WARM_CL, STEPS_CL


def _pallas(rt, mc, dev):
    return _bench(rt, mc, dev, engine="pallas")


def _pallas_stoch(rt, mc, dev):
    return _bench(rt, mc, dev, engine="pallas", n_games=B_STOCH,
                  stochastic=True, noise=1.0)


def _exact_stoch(rt, mc, dev):
    return _bench(rt, mc, dev, engine="pallas_exact", n_games=B_STOCH,
                  stochastic=True, noise=1.0)


def _event(rt, mc, dev):
    return _bench(rt, mc, dev, engine="event", warm=10, steps=10)


def _event_golden(rt, mc, dev):
    import os

    import numpy as np
    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "golden", "kick_goal_10s")
    sched = torch.from_numpy(np.loadtxt(base + ".sched.txt").reshape(
        -1, 1, 4, 2)).to(dev)
    p = rt.SimParams(dtype="float64", winning_score=100)

    def schedule(k, states):
        return k + 1, sched[k]

    s = rt.initial_state(p, x0_puck=[-1.0, 0.0, 0.0, 0.0], device=dev)
    s, k = mc._run_batch(s, p, 135, schedule, 0, device=dev)
    return p, schedule, s, k, 1, 135, 2


PATHS = {"bench": _bench, "classical_cbf": _classical_cbf, "dmpc": _dmpc,
         "cmpc": _cmpc, "pallas": _pallas, "pallas_stoch": _pallas_stoch,
         "exact_stoch": _exact_stoch, "event": _event,
         "event_golden": _event_golden}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=tuple(PATHS), default="bench")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: no CUDA device")
    import robogame_tpu_torch as rt
    mc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    p, policy, s, ps, n_games, warm, steps = PATHS[args.path](rt, mc, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s, ps = mc._run_batch(s, p, steps, policy, ps, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                ev.device_time_total > 0:
            rows.append((ev.device_time_total, ev.key, ev.count))
    busy_us = sum(r[0] for r in rows)
    print(f"card: {card}")
    print(f"path {args.path}: B={n_games}, steps {warm}..{warm + steps}: "
          f"{wall / steps * 1e3:.4f} ms wall per step (traced), "
          f"{sum(r[2] for r in rows) / steps:.1f} device launches a step")
    if not rows:
        print("device time: not measured (the trace holds no device events)")
        return
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall: "
          f"{busy_us / (wall * 1e6):.4f}")
    rest = busy_us
    for label, frag in GROUPS:
        us = sum(r[0] for r in rows if frag in r[1])
        n = sum(r[2] for r in rows if frag in r[1])
        rest -= us
        print(f"  {label}: {us / steps:10.2f} us/step  {n} launches")
    print(f"  glue (every other kernel and copy): {rest / steps:10.2f} "
          f"us/step")
    print(f"  device idle: {(wall * 1e6 - busy_us) / steps:10.2f} us/step")
    for dev_us, key, count in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / steps:10.2f} us/step  {count:6d} launches  "
              f"{key[:90]}")


if __name__ == "__main__":
    main()
