"""Large-sample distributional-equivalence campaign: the port's fast
engines against its event engine.

The event engine equals the compiled reference's golden logs bitwise over
their first 100 steps in f64 (tests/test_torch_parity.py); this campaign
is the evidence that the fast engines -- the sweep engine, K6
(``engine="pallas"``) and K1 (``engine="pallas_exact"``) -- are
statistically equivalent to it at scale, beyond the nine golden
scenarios.

Workload families (all open loop, so both engines see the same inputs):

* ``uniform``: per-game piecewise-constant U(-8, 8) schedules, random
  puck;
* ``corner``: all four players driven into one random corner all game (a
  sustained pile-up grinding the walls: the event cap's stressor);
* ``squeeze``: the teams driven head-on into each other, flipping every 20
  steps (repeated fast player-player impacts);
* ``noise``: uniform and corner at noise 1.0, compared distributionally.

For each pair it reports the per-game final-score exact-match rate (same
seeds, same schedules), the total goals' and total damage's mean
difference and z-score, and KS statistics of the final puck speed, puck x
and player x.  Pairs: sweep against event at the reference's 50-event
cap, both engines at cap 12 (``--skip-cap12`` leaves them out), K6
against the sweep engine, K1 against the event engine.

The reference's known deviations show here and are reported, not counted
as faults: K6 and the sweep engine split on corner grinders, K1's
corner+noise damage runs about 10% low, corner damage is heavy-tailed.

    python -m robogame_tpu_torch.tools.dist_equiv [--games 10000]
        [--steps 100] [--families uniform,corner,squeeze,noise]
        [--json out.json] [--skip-cap12] [--cpu]

(The JAX tool's ``--block``, ``--dump-refs``, ``--load-refs`` and
``--cache`` split and resumed the campaign around its TPU worker's
execution limit; one process on the card runs it whole.)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib

import numpy as np
import torch

from ..config import SimParams
from ..examples import add_cpu_flag, driver_device, host
from ..parallel.monte_carlo import McParams, _initial_states
from ..physics.step import step_batch
from ..state import GameState

PROG = "python -m robogame_tpu_torch.tools.dist_equiv"


def make_states(G: int, params: SimParams, device="cuda") -> GameState:
    """Seeds 1..G with random pucks (``monte_carlo``'s starts)."""
    return _initial_states(params, McParams(num_runs=G, randomize_x0=True),
                           device=device)


def make_sched(family: str, G: int, n_steps: int, seed: int = 0):
    """(n_steps, G, 4, 2) open-loop velocity commands."""
    rng = np.random.default_rng(seed)
    if family == "uniform":
        hold = 10
        u = rng.uniform(-8, 8, ((n_steps + hold - 1) // hold, G, 4, 2))
        u = np.repeat(u, hold, axis=0)[:n_steps]
    elif family == "corner":
        corner = rng.choice([-8.0, 8.0], size=(1, G, 1, 2))
        u = np.broadcast_to(corner, (n_steps, G, 4, 2)).copy()
    elif family == "squeeze":
        u = np.zeros((n_steps, G, 4, 2))
        flip = (np.arange(n_steps) // 20 % 2) * 2 - 1   # +-1 every 20
        u[:, :, 0:2, 0] = 8.0 * flip[:, None, None]     # team A x-drive
        u[:, :, 2:4, 0] = -8.0 * flip[:, None, None]    # team B opposite
        u[:, :, :, 1] = rng.uniform(-2, 2, (1, G, 4))   # slight y spread
    else:
        raise ValueError(family)
    return u.astype(np.float32)


class Final:
    """A rollout's final x, score and damage as numpy arrays (what
    :func:`compare` reads)."""

    def __init__(self, x, score, damage):
        self.x, self.score, self.damage = x, score, damage


def dump_final(path, f: Final) -> None:
    """Save a rollout's final arrays as ``.npz`` (keys x, score, damage),
    the JAX tool's format: a dump of either package loads in the other."""
    np.savez(path, x=f.x, score=f.score, damage=f.damage)


def load_final(path) -> Final:
    """A :func:`dump_final` file (or the JAX tool's) as a :class:`Final`."""
    with np.load(path) as z:
        return Final(z["x"], z["score"], z["damage"])


def rollout(engine: str, states: GameState, sched, params_base: SimParams,
            sweep_iters: int | None = None, stochastic: bool = False):
    """Step ``states`` through ``sched`` on ``engine``; (the final states
    on the host, seconds)."""
    kw = dict(engine=engine, stochastic=stochastic,
              noise=1.0 if stochastic else 0.0)
    if sweep_iters is not None:
        kw["sweep_iters"] = sweep_iters
    params = params_base.replace(**kw)
    dev = states.x.device
    u_all = torch.as_tensor(sched, device=dev)
    t0 = time.perf_counter()
    s = states
    for k in range(u_all.shape[0]):
        s = step_batch(s, u_all[k], params, device=dev)
    out = Final(host(s.x), host(s.score), host(s.damage))
    return out, time.perf_counter() - t0


def ks_stat(a, b) -> float:
    """Two-sample Kolmogorov-Smirnov statistic."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    ca = np.searchsorted(a, grid, side="right") / len(a)
    cb = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.max(np.abs(ca - cb)))


def compare(f_ref, f_fast, label: str) -> dict:
    """The comparison record of two rollouts of the same games, printed as
    one JSON line."""
    G = f_ref.score.shape[0]
    score_match = float(np.mean(np.all(f_ref.score == f_fast.score,
                                       axis=1)))
    goals_r = f_ref.score.sum(1).astype(float)
    goals_f = f_fast.score.sum(1).astype(float)
    dmg_r = f_ref.damage.sum((1, 2))
    dmg_f = f_fast.damage.sum((1, 2))

    def zdiff(a, b):
        se = np.sqrt((a.var() + b.var()) / len(a) + 1e-12)
        return float((a.mean() - b.mean()) / se)

    puck_speed_r = np.linalg.norm(f_ref.x[:, 4, 2:4], axis=1)
    puck_speed_f = np.linalg.norm(f_fast.x[:, 4, 2:4], axis=1)
    res = dict(
        label=label, games=G,
        score_match_rate=round(score_match, 4),
        goals_mean=(round(goals_r.mean(), 4), round(goals_f.mean(), 4)),
        goals_z=round(zdiff(goals_r, goals_f), 2),
        damage_mean=(round(float(dmg_r.mean()), 3),
                     round(float(dmg_f.mean()), 3)),
        damage_rel_diff=round(
            float(abs(dmg_r.mean() - dmg_f.mean())
                  / (abs(dmg_r.mean()) + 1e-9)), 4),
        damage_z=round(zdiff(dmg_r, dmg_f), 2),
        ks_puck_speed=round(ks_stat(puck_speed_r, puck_speed_f), 4),
        ks_puck_x=round(ks_stat(f_ref.x[:, 4, 0], f_fast.x[:, 4, 0]), 4),
        ks_player_x=round(ks_stat(f_ref.x[:, :4, 0].ravel(),
                                  f_fast.x[:, :4, 0].ravel()), 4),
    )
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--games", type=int, default=10000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--families", default="uniform,corner,squeeze,noise",
                    help="comma-separated subset")
    ap.add_argument("--json", default=None,
                    help="write all comparison records here")
    ap.add_argument("--skip-cap12", action="store_true",
                    help="leave out the cap-12 pairs")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = driver_device(args, PROG)

    params = SimParams(dtype="float32")
    G, n = args.games, args.steps
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# dist_equiv: G={G} steps={n} platform={dev.type} ({name})",
          flush=True)
    records = []

    def rate(t):
        return f"{G * n / t:.0f} steps/s"

    wanted = set(args.families.split(","))
    for family in ("uniform", "corner", "squeeze"):
        if family not in wanted:
            continue
        states = make_states(G, params, dev)
        # zlib.crc32: the same schedules in every process (hash() is
        # salted)
        sched = make_sched(family, G, n,
                           seed=zlib.crc32(family.encode()) % 2**31)
        f_ev, t_ev = rollout("event", states, sched, params)
        print(f"# {family}: event {rate(t_ev)}", flush=True)
        f_sw, t_sw = rollout("sweep", states, sched, params)
        print(f"# {family}: sweep {rate(t_sw)}", flush=True)
        # the default sweep_iters is the reference's 50-event cap
        records.append(compare(f_ev, f_sw, f"{family}: sweep50-vs-event50"))
        if not args.skip_cap12:
            # both engines at cap 12: the gap that is not the cap's
            f_s12, _ = rollout("sweep", states, sched, params,
                               sweep_iters=12)
            f_e12, _ = rollout("event", states, sched,
                               params.replace(collision_counter_lim=12))
            records.append(compare(f_e12, f_s12,
                                   f"{family}: sweep12-vs-event12"))
        f_pl, t_pl = rollout("pallas", states, sched, params)
        print(f"# {family}: pallas {rate(t_pl)}", flush=True)
        records.append(compare(f_sw, f_pl, f"{family}: pallas-vs-sweep"))
        # the event-order-exact kernel against the event engine: the same
        # event semantics, populate roundoff apart
        f_px, t_px = rollout("pallas_exact", states, sched, params)
        print(f"# {family}: pallas_exact {rate(t_px)}", flush=True)
        records.append(compare(f_ev, f_px, f"{family}: exact-vs-event50"))

    # stochastic variants, distributional only: the engines draw their
    # noise through different models (the sweep engine and K1 through the
    # stage covariance, the event engine per stage); the corner family
    # also exercises K1's re-propagation noise
    if "noise" in wanted:
        for nfam in ("uniform", "corner"):
            states = make_states(G, params, dev)
            sched = make_sched(nfam, G, n,
                               seed=7 if nfam == "uniform"
                               else zlib.crc32(b"corner") % 2**31)
            f_ev, _ = rollout("event", states, sched, params,
                              stochastic=True)
            for engine, tag in (("sweep", "sweep"), ("pallas_exact",
                                                      "exact")):
                f_fast, _ = rollout(engine, states, sched, params,
                                    stochastic=True)
                records.append(compare(
                    f_ev, f_fast, f"{nfam}+noise1.0: {tag}-vs-event "
                    "(distributional)"))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(games=G, steps=n, device=name, records=records),
                      f, indent=1)
        print(f"# wrote {args.json}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
