"""A window of open-loop Monte-Carlo sweeps through ``monte_carlo()``.

Set-up builds the program's kernels and runs a short warm-up sweep at the
cell's batch.  The window then calls ``monte_carlo(params, mc,
policy=..., policy_state=(table, 0), mesh=...)`` sweep after sweep, each
with the traffic's schedule table for that sweep (batch-leading, so that a
mesh shards it), and fetches each sweep's scores to the host, as users do.
It ends at the first sweep boundary at or past ``--seconds``.

The policy the sweep calls is the benchmark's: it looks up the step's
controls, marks the step on the device's stream (a CUDA event) and the
host clock, and at a few steps drawn from the seed keeps the states of a
sample of games drawn from the seed.  After the window the plain
reference steps the kept states again (``check``).

Over a mesh (``entries/mesh_sweep.py``) every rank runs this with its
process group in place; rank 0 decides when the window ends and gathers
what the others kept.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from benchmark import check as chk
from benchmark import generate, harness
from benchmark.reference import physics, starts

WARM_STEPS = 20
WARM_INDEX = 1 << 30          # the warm-up sweep's table, no window's


def _params(cfg: dict, B: int):
    from robogame_tpu_torch.config import SimParams
    from robogame_tpu_torch.parallel.monte_carlo import McParams
    m = cfg["McParams"]
    params = SimParams(**cfg["SimParams"])
    mc = McParams(num_runs=B, T=m["T"], randomize_x0=m["randomize_x0"],
                  x0_pos_range=tuple(m["x0_pos_range"]),
                  x0_vel_range=m["x0_vel_range"])
    return params, mc


def _plan(seed: int, i: int, B: int, world: int, n: int, sample: dict):
    """Sweep ``i``'s sample: global game indices (an equal share from each
    rank's slice) and the steps whose states are kept."""
    r = generate.rng(seed, "sample", i)
    per, k = sample["games"] // world, B // world
    games = np.concatenate([np.sort(r.choice(k, per, replace=False)) + q * k
                            for q in range(world)])
    ks = r.choice(np.arange(1, n - 1), sample["pairs"], replace=False)
    steps = {0, n - 1} | {int(a) for a in ks} | {int(a) + 1 for a in ks}
    return games, steps


class Probe:
    """The policy handed to ``monte_carlo``: the schedule's controls, a mark
    on the stream and the host clock a call, and the kept states."""

    def __init__(self, clock, rank: int, local_b: int):
        self.clock, self.rank, self.local_b = clock, rank, local_b
        self.host = []
        self.kept = {}
        self.on = False
        self.tracer = None

    def begin(self, i: int, games, steps, dev):
        lo = self.rank * self.local_b
        mine = games[(games >= lo) & (games < lo + self.local_b)]
        self.i, self.steps = i, steps
        self.local = torch.as_tensor(mine - lo, device=dev)
        self.kept[(i, "games")] = torch.as_tensor(games)
        self.host.append([])
        self.clock.start_series()
        self.on = True

    def policy(self, ps, s):
        table, k = ps
        tr = self.tracer
        if tr is not None:
            if k == 0:
                tr.start()
            tr.span("bench.policy")
        u = table[:, k // self.hold]
        if tr is not None:
            tr.span("bench.step")
        if self.on:
            self.clock.mark()
            self.host[-1].append(time.perf_counter())
            if k in self.steps:
                idx = self.local
                self.kept[(self.i, k)] = (tuple(f[idx] for f in s), u[idx])
        return (table, k + 1), u


def run(ctx) -> dict:
    from robogame_tpu_torch.parallel.monte_carlo import monte_carlo
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    cuda = dev.type == "cuda"
    mesh = getattr(ctx, "mesh", None)
    rank, world = ctx.rank, getattr(ctx, "world", 1)
    B = mix["games"]
    params, mc = _params(cfg, B)
    n = int(np.ceil(mc.T / params.dt))
    clock = harness.StepClock(cuda)
    probe = Probe(clock, rank, B // world)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    def sweep(i, mcp=mc, keep=True, tracer=None):
        table, hold = generate.schedule_table(mix, ctx.seed, i, n, dev,
                                              params.torch_dtype)
        probe.hold, probe.tracer = hold, tracer
        if keep:
            games, steps = _plan(ctx.seed, i, B, world, n, cfg["sample"])
            probe.begin(i, games, steps, dev)
        else:
            probe.on = False
        t_call = time.perf_counter()
        res = monte_carlo(params, mcp, policy=probe.policy,
                          policy_state=(table, 0), mesh=mesh, device=dev)
        if keep:
            clock.mark()
        t_ret = time.perf_counter()
        if tracer is not None:
            tracer.span("bench.fetch")
        res.scores.cpu()                          # the host fetch
        t_fetch = time.perf_counter()
        if tracer is not None:
            tracer.stop()
        if keep and rank == 0:
            g = torch.as_tensor(games, device=res.scores.device)
            probe.kept[(i, "final")] = (res.scores[g], res.damage[g],
                                        res.t_final[g])
        return t_call, t_ret, t_fetch

    # set-up: the kernels build and load, the shapes warm up
    harness.note(f"set-up: warm-up sweep at "
                 f"{harness.now() - ctx.t_start:.2f} s")
    warm_T = (min(WARM_STEPS, n) - 0.5) * params.dt     # ceil(T / dt) steps
    sweep(WARM_INDEX, dataclasses.replace(mc, T=warm_T), keep=False)
    sync()
    if mesh is not None:
        dist.barrier()
    setup_s = harness.now() - ctx.t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    marks = []
    counts = harness.counters()
    t0 = time.perf_counter()
    i = 0
    while True:
        t_call, t_ret, t_fetch = sweep(i)
        host = probe.host[-1]
        marks.append({"call": t_call - t0, "policy": [h - t0 for h in host],
                      "return": t_ret - t0, "fetch": t_fetch - t0})
        harness.note(f"sweep {i}: starts {host[0] - t_call:.3f} s, steps "
                     f"{host[-1] - host[0]:.3f} s, last step and return "
                     f"{t_ret - host[-1]:.4f} s, fetch {t_fetch - t_ret:.4f} s")
        i += 1
        done = torch.tensor([float(t_fetch - t0 >= ctx.seconds)],
                            device=dev)
        if mesh is not None:
            dist.broadcast(done, 0)
        if done.item() > 0:
            break
    window_s = time.perf_counter() - t0
    sync()
    counts = harness.counter_delta(counts, harness.counters())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    durations = clock.durations()
    probe.on = False
    tr = None
    if ctx.trace:
        tracer = harness.Tracer(cuda)
        sweep(i, keep=False, tracer=tracer)
        tr = tracer.read(n)
    run = {"kind": "sweep", "sweeps": i, "games": B, "steps_per_game": n,
           "window_s": window_s, "setup_s": setup_s,
           "game_steps": i * B * n, "step_s": durations,
           "marks": marks, "counters": counts,
           "trace": tr, "world": world, "peak": peak, "cfg": cfg,
           "attempted": i * B, "failed": 0}
    kept = {k: _cpu(v) for k, v in probe.kept.items()}
    if mesh is not None:
        run, kept = _gather_ranks(run, kept, rank, world)
    run["kept"] = kept
    return run


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return type(tree)(_cpu(a) for a in tree)


def _gather_ranks(run: dict, kept: dict, rank: int, world: int):
    """Rank 0's run with every rank's kept states merged (each rank keeps
    the games of its own slice) and the fullest card's peak; the traces'
    busy seconds averaged over the cards."""
    parts = [None] * world
    mine = {"kept": kept, "peak": run["peak"],
            "busy_s": run["trace"]["busy_s"] if run["trace"] else None}
    dist.all_gather_object(parts, mine)
    if rank != 0:
        return run, kept
    merged = {}
    for key in parts[0]["kept"]:
        if not isinstance(key[1], int):
            merged[key] = parts[0]["kept"][key]
            continue
        vals = [p["kept"][key] for p in parts]
        state = tuple(torch.cat([v[0][f] for v in vals])
                      for f in range(len(vals[0][0])))
        merged[key] = (state, torch.cat([v[1] for v in vals]))
    run["peak"] = max(p["peak"] for p in parts)
    if run["trace"]:
        run["trace"]["busy_s"] = float(np.mean([p["busy_s"] for p in parts]))
    return run, merged


def check(run: dict, cfg: dict, dev) -> tuple:
    """The numbers compared, each (name, value, limit), and the answers
    that broke their limit.  The reference steps on ``dev``."""
    return compare(answers_of(run), cfg, dev)


def answers_of(run: dict) -> dict:
    return answers(run["kept"], run["steps_per_game"])


def answers(kept: dict, n: int) -> dict:
    """What the window produced, with what it was produced from: the
    sampled games' starts (with the games' indices); each kept state, its
    controls and the state the program handed the policy a step later; the
    last step's state and controls with the sweep's result for those
    games (under a mesh, the all-gathered one)."""
    out = {"starts": [], "pairs": [], "finals": []}
    for i in sorted({k[0] for k in kept}):
        steps = sorted(k[1] for k in kept
                       if k[0] == i and isinstance(k[1], int))
        for k in steps:
            state, u = kept[(i, k)]
            if k == 0:
                out["starts"].append((kept[(i, "games")], state))
            if k + 1 in steps:
                out["pairs"].append((state, u, kept[(i, k + 1)][0]))
            if k == n - 1:
                out["finals"].append((state, u, kept[(i, "final")]))
    return out


def _cat(parts, f):
    return torch.cat([p[f] for p in parts])


def reference_outputs(ans: dict, cfg: dict, dev, dtype) -> dict:
    """The same answers with every output worked out by the reference in
    ``dtype`` from the same inputs (``control.py``'s control)."""
    sp = cfg["SimParams"]
    out = {"starts": [(g, tuple(a.to(s[i].dtype) for i, a in enumerate(
        starts.sweep_starts(sp, cfg["McParams"], g.tolist(), dtype))))
        for g, s in ans["starts"]]}
    for kind in ("pairs", "finals"):
        rows = []
        for s, u, _ in ans[kind]:
            o = _ref_steps(sp, *(a.to(dev) for a in s[:4]), u.to(dev), dtype)
            o = [a.to(b.dtype).cpu() for a, b in zip(o, s)]
            rows.append((s, u, (*o, s[4]) if kind == "pairs" else
                         (o[1], o[2], o[3])))
        out[kind] = rows
    return out


def compare(ans: dict, cfg: dict, dev, dtype=torch.float32):
    """start_gap: the sampled games' starts against the reference's;
    step_gap: each kept state stepped by the reference against the state
    a step later (a deterministic step leaves the random stream as it
    was); final_gap: the last step's score, damage and time against the
    sweep's result.  ``dtype``: the reference's precision."""
    sp, lim = cfg["SimParams"], cfg["limits"]
    readings, bad = [], 0
    got = [s for _, s in ans["starts"]]
    want = [starts.sweep_starts(sp, cfg["McParams"], g.tolist(), dtype)
            for g, _ in ans["starts"]]
    g = [chk.state_gap([_cat(got, f) for f in range(5)],
                       [_cat(want, f) for f in range(5)])] if got else []
    r, b = chk.reading("start_gap", g, lim)
    readings.append(r)
    bad += b
    for name, rows in (("step_gap", ans["pairs"]),
                       ("final_gap", ans["finals"])):
        g = []
        if rows:
            src = [s for s, _, _ in rows]
            x, sc, dm, t = (_cat(src, f).to(dev) for f in range(4))
            out = _ref_steps(sp, x, sc, dm, t,
                             torch.cat([u for _, u, _ in rows]).to(dev), dtype)
            res = [o for _, _, o in rows]
            if name == "step_gap":
                g = [chk.state_gap(out + [_cat(src, 4)],
                                   [_cat(res, f) for f in range(5)])]
            else:
                g = [chk.state_gap(out[1:], [_cat(res, f) for f in range(3)])]
        r, b = chk.reading(name, g, lim)
        readings.append(r)
        bad += b
    return readings, bad


def _ref_steps(sp, x, sc, dm, t, u, dtype, chunk: int = 16384):
    outs = [physics.step(sp, x[a:a + chunk], sc[a:a + chunk],
                         dm[a:a + chunk], t[a:a + chunk], u[a:a + chunk],
                         dtype) for a in range(0, x.shape[0], chunk)]
    return [torch.cat([o[f] for o in outs]) for f in range(4)]
