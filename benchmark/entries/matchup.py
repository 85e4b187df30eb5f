"""A window of closed-loop matchup steps: a pairing's policy and
``step_batch`` (K1, two-phase), game after game.

The configuration names the pairing under ``policy``: the program's
function that builds it (``function``, a dotted name such as
``robogame_tpu_torch.agents.dmpc_team.dmpc_matchup``, called as
``function(params, games, **args, <key>=<group>(**cfg[<group>]),
device=...)`` for each ``params`` entry ``<key>: <group>``, a parameter
class of ``robogame_tpu_torch.config``) and its ``args`` (the opponent,
the filter); and under ``reference`` the plain reference of that policy,
``reference/<reference>.py``, whose ``policy(x, carry, cfg, dtype)``
returns the controls and the new carry in the program's layout (the
program's carry as :func:`harness.plain` gives it).

``monte_carlo()`` takes no seed (its games are always seeds 1..B), so the
window drives the loop of ``monte_carlo``'s ``_run_batch`` over public
entries: each episode starts from ``initial_state(params, x0_puck,
seed=[...])`` with the puck starts and game seeds the traffic draws from
``--seed`` and a fresh policy state, then calls the policy and
``step_batch`` a control step for the configuration's game length.  The
window ends with the step in progress at ``--seconds``.

Each step is marked on the card's stream (a CUDA event before and after
the policy call) and on the host clock.  At a few steps of each episode
drawn from the seed, the states, the policy's carry in and out and its
controls are kept, with the states after the step; after the window the
plain reference solves the kept steps' policy again from the same state
and carry and steps the physics (``check``).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from benchmark import check as chk
from benchmark import generate, harness
from benchmark.reference import physics, starts

WARM_STEPS = 3
WARM_INDEX = 1 << 30
TRACE_STEPS = 40


def build_policy(cfg: dict, params, games: int, dev):
    """The configuration's pairing: (policy, initial carry)."""
    from robogame_tpu_torch import config
    spec = cfg["policy"]
    where, name = spec["function"].rsplit(".", 1)
    make = getattr(importlib.import_module(where), name)
    groups = {k: getattr(config, group)(**cfg[group])
              for k, group in spec.get("params", {}).items()}
    return make(params, games, **spec.get("args", {}), **groups, device=dev)


def reference_policy(cfg: dict):
    """The plain reference of the configuration's pairing."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def run(ctx) -> dict:
    from robogame_tpu_torch.config import SimParams
    from robogame_tpu_torch.physics.step import step_batch
    from robogame_tpu_torch.state import initial_state
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    cuda = dev.type == "cuda"
    params = SimParams(**cfg["SimParams"])
    B = mix["games"]
    n = int(np.ceil(cfg["McParams"]["T"] / params.dt))
    policy, ps0 = build_policy(cfg, params, B, dev)
    clock = harness.StepClock(cuda)
    pol = harness.StepClock(cuda)
    kept, marks = {}, []

    def episode(e):
        x0, seeds = generate.closed_loop_starts(mix, ctx.seed, e, dev,
                                                params.torch_dtype)
        x0, seeds = x0.cpu(), seeds.cpu().tolist()
        s = initial_state(params, x0_puck=x0, seed=seeds, device=dev)
        return s, ps0, (x0, torch.tensor(seeds))

    def plan(e):
        r = generate.rng(ctx.seed, "sample", e)
        ks = r.choice(np.arange(0, n - 1), cfg["sample"]["pairs"],
                      replace=False)
        return {int(a) for a in ks}

    # set-up: the kernels build and load, the shapes warm up
    harness.note(f"set-up: warm-up steps at "
                 f"{harness.now() - ctx.t_start:.2f} s")
    s, ps, _ = episode(WARM_INDEX)
    for _ in range(WARM_STEPS):
        ps, u = policy(ps, s)
        s = step_batch(s, u, params, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = harness.now() - ctx.t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    clock.start_series()
    counts = harness.counters()
    steps, e, k = 0, -1, n
    t0 = time.perf_counter()
    while True:
        if k == n:
            e, k = e + 1, 0
            marks.append({"start": time.perf_counter() - t0, "policy": []})
            s, ps, inputs = episode(e)
            kept[(e, "starts")] = (s, inputs)
            pairs = plan(e)
        clock.mark()
        marks[-1]["policy"].append(time.perf_counter() - t0)
        if (e, k - 1) in kept:                      # the state after a
            kept[(e, k - 1)] += (s,)                # kept step
        pol.start_series()
        pol.mark()
        if k in pairs:
            kept[(e, k)] = (s, harness.plain(ps, clone=True))
        ps, u = policy(ps, s)
        pol.mark()
        if k in pairs:
            kept[(e, k)] += (u, harness.plain(ps, clone=True))
        s = step_batch(s, u, params, device=dev)
        steps += 1
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    clock.mark()
    if (e, k - 1) in kept:
        kept[(e, k - 1)] += (s,)
    window_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize(dev)
    counts = harness.counter_delta(counts, harness.counters())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tr = None
    if ctx.trace:
        tracer = harness.Tracer(cuda)
        tracer.start()
        for _ in range(TRACE_STEPS):
            tracer.span("bench.policy")
            ps, u = policy(ps, s)
            tracer.span("bench.step")
            s = step_batch(s, u, params, device=dev)
        tracer.stop()
        tr = tracer.read(TRACE_STEPS)
    harness.note(f"{steps} steps in {window_s:.3f} s over {e + 1} "
                 f"episode(s)")
    cpu = lambda t: tuple(cpu(a) for a in t) if isinstance(t, tuple) \
        else t.detach().cpu()
    return {"kind": "matchup", "games": B, "steps": steps,
            "game_steps": steps * B, "window_s": window_s,
            "setup_s": setup_s, "step_s": clock.durations(),
            "policy_s": [d for series in pol.durations() for d in series],
            "marks": marks, "counters": counts,
            "trace": tr, "world": 1, "peak": peak, "cfg": cfg,
            "attempted": steps * B, "failed": 0,
            "kept": {key: cpu(v) for key, v in kept.items()}}


def check(run: dict, cfg: dict, dev) -> tuple:
    """The numbers compared, each (name, value, limit), and the answers
    that broke their limit.  The reference runs on ``dev``."""
    return compare(answers_of(run), cfg, dev)


def answers_of(run: dict) -> dict:
    return answers(run["kept"])


def answers(kept: dict) -> dict:
    """What the window produced, with what it was produced from: each
    episode's starts with its puck starts and seeds; each kept step's
    state, the policy's carry in, its controls, its carry out and the
    state after the step."""
    return {"starts": [v for key, v in kept.items() if key[1] == "starts"],
            "steps": [v for key, v in kept.items()
                      if isinstance(key[1], int) and len(v) == 5]}


def _policy(s, carry, cfg, dev, dtype):
    """The reference policy from the kept state and carry in: (controls,
    carry out) on the host."""
    to = lambda t: None if t is None else t.to(dev) \
        if isinstance(t, torch.Tensor) else tuple(to(a) for a in t)
    u, new = reference_policy(cfg).policy(s[0].to(dev), to(carry), cfg,
                                          dtype)
    return u.cpu(), _host(new)


def _host(t):
    if t is None or isinstance(t, torch.Tensor):
        return None if t is None else t.detach().cpu()
    return tuple(_host(a) for a in t)


def _like(t, ref):
    """``t`` in the dtypes of ``ref`` (the same layout)."""
    if t is None or isinstance(t, torch.Tensor):
        return None if t is None else t.to(ref.dtype)
    return tuple(_like(a, b) for a, b in zip(t, ref))


def reference_outputs(ans: dict, cfg: dict, dev, dtype) -> dict:
    """The same answers with every output worked out by the reference in
    ``dtype`` from the same inputs (``control.py``'s control)."""
    sp = cfg["SimParams"]
    st = []
    for s, (x0, seeds) in ans["starts"]:
        ref = starts.given_starts(sp, x0, seeds, dtype)
        st.append((tuple(a.to(b.dtype) for a, b in zip(ref, s)),
                   (x0, seeds)))
    steps = []
    for s, carry, u, carry_out, s_next in ans["steps"]:
        u_c, c_c = _policy(s, carry, cfg, dev, dtype)
        o = physics.step(sp, *(a.to(dev) for a in s[:4]), u.to(dev), dtype)
        o = tuple(a.to(b.dtype).cpu() for a, b in zip(o, s)) + (s[4],)
        steps.append((s, carry, u_c.to(u.dtype), _like(c_c, carry_out), o))
    return {"starts": st, "steps": steps}


def compare(ans: dict, cfg: dict, dev, dtype=torch.float32):
    """start_gap: each episode's starts against the reference's from the
    same puck starts and seeds; step_gap: each kept state stepped by the
    reference with the program's controls against the state after the
    step; policy_miss: the share of the kept steps' player controls that
    lie further from the reference policy's than the configuration's
    ``policy_tolerance``; carry_miss: the share of the kept steps' games
    whose carry out (the warm state the policy hands its next step) lies
    further, in some entry, from the one the reference policy returns from
    the same carry in.  ``dtype``: the reference's precision."""
    sp, lim = cfg["SimParams"], cfg["limits"]
    readings, bad = [], 0
    got = [s for s, _ in ans["starts"]]
    want = [starts.given_starts(sp, x0, seeds, dtype)
            for _, (x0, seeds) in ans["starts"]]
    cat = lambda parts, f: torch.cat([p[f] for p in parts])
    g = [chk.state_gap([cat(got, f) for f in range(5)],
                       [cat(want, f) for f in range(5)])] if got else []
    r, b = chk.reading("start_gap", g, lim)
    readings.append(r)
    bad += b
    gaps, u_ref, u_got, c_miss = [], [], [], []
    tol = cfg["policy_tolerance"]
    for s, carry, u, carry_out, s_next in ans["steps"]:
        out = physics.step(sp, *(a.to(dev) for a in s[:4]), u.to(dev),
                           dtype)
        gaps.append(chk.state_gap(list(out) + [s[4]], s_next))
        u_c, c_c = _policy(s, carry, cfg, dev, dtype)
        u_ref.append(u_c.reshape(-1, 2))
        u_got.append(u.reshape(-1, 2))
        c_miss.append(chk.tree_miss(carry_out, c_c, tol["atol"],
                                    tol["rtol"]))
    r, b = chk.reading("step_gap", gaps, lim)
    readings.append(r)
    bad += b
    for name, (share, misses) in (
            ("policy_miss", chk.miss_share(u_got, u_ref, tol["atol"],
                                           tol["rtol"])),
            ("carry_miss", chk.share(c_miss))):
        lim_p = float(lim[name])
        readings.append((name, share, lim_p))
        bad += misses if share > lim_p else 0
    return readings, bad
