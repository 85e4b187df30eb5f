"""The port's distributional-equivalence campaign
(``robogame_tpu_torch.tools.dist_equiv``) against the JAX package's
(tools/dist_equiv.py), and its guards.

* ``compare`` and ``ks_stat`` give JAX's records on the same arrays, and
  ``make_sched`` JAX's schedules, for every family;
* the campaign runs on the CPU at 16 games x 6 steps (uniform and noise
  families): every pair's record, the sweep engine's scores equal the
  event engine's in every uniform game;
* marked slow, at JAX's in-suite size and with its thresholds
  (tests/test_dist_equiv.py: 192 games x 50 steps, corner 100 steps):
  the port's sweep engine against the port's event engine on uniform
  schedules at the reference's 50-event cap, on squeeze schedules with
  both capped at 12, stochastic, and on corner grinders (cap 12), where
  the sweep engine's damage runs high.
"""

import os
import sys

import numpy as np
import pytest

from robogame_tpu_torch.config import SimParams
from robogame_tpu_torch.tools import dist_equiv as de

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import dist_equiv as jde  # noqa: E402
from _port_env import port_module  # noqa: E402,F401  (autouse fixture)

G, STEPS = 192, 50


def _finals(rng, n, cls):
    return cls(rng.normal(size=(n, 5, 4)), rng.integers(0, 4, (n, 2)),
               rng.exponential(1.0, (n, 4, 4)))


def test_compare_and_ks_stat_equal_jax(capsys):
    rng = np.random.default_rng(5)
    for n in (7, 300):
        a, b = rng.normal(size=n), rng.normal(0.2, 1.5, size=n + 3)
        assert de.ks_stat(a, b) == jde.ks_stat(a, b)
        ref = _finals(np.random.default_rng(n), n, de.Final)
        fast = _finals(np.random.default_rng(n + 1), n, de.Final)
        fast.score[: n // 2] = ref.score[: n // 2]
        assert de.compare(ref, fast, "x") == jde.compare(ref, fast, "x")
    capsys.readouterr()


def test_make_sched_equals_jax():
    for family in ("uniform", "corner", "squeeze"):
        for seed in (0, 11):
            np.testing.assert_array_equal(
                de.make_sched(family, 9, 23, seed=seed),
                jde.make_sched(family, 9, 23, seed=seed))


def test_campaign_runs_on_the_cpu(tmp_path, capsys):
    import json
    path = str(tmp_path / "de.json")
    assert de.main(["--games", "16", "--steps", "6", "--families",
                    "uniform,noise", "--json", path, "--cpu"]) == 0
    with open(path) as f:
        out = json.load(f)
    labels = [r["label"] for r in out["records"]]
    assert labels == [
        "uniform: sweep50-vs-event50", "uniform: sweep12-vs-event12",
        "uniform: pallas-vs-sweep", "uniform: exact-vs-event50",
        "uniform+noise1.0: sweep-vs-event (distributional)",
        "uniform+noise1.0: exact-vs-event (distributional)",
        "corner+noise1.0: sweep-vs-event (distributional)",
        "corner+noise1.0: exact-vs-event (distributional)"]
    assert out["records"][0]["score_match_rate"] == 1.0
    capsys.readouterr()


@pytest.fixture(scope="module")
def params():
    return SimParams(dtype="float32")


def _pair(family, params, ref_iters=None, fast_iters=None, seed=11,
          steps=STEPS, stochastic=False):
    states = de.make_states(G, params, "cpu")
    sched = de.make_sched(family, G, steps, seed=seed)
    p_ref = params if ref_iters is None else params.replace(
        collision_counter_lim=ref_iters)
    f_ref, _ = de.rollout("event", states, sched, p_ref,
                          stochastic=stochastic)
    f_fast, _ = de.rollout("sweep", states, sched, params,
                           sweep_iters=fast_iters, stochastic=stochastic)
    return f_ref, f_fast


@pytest.mark.slow
def test_uniform_schedules_indistinguishable(params):
    f_ev, f_sw = _pair("uniform", params)
    res = de.compare(f_ev, f_sw, "suite: uniform sweep50-vs-event50")
    assert res["score_match_rate"] == 1.0
    assert res["damage_rel_diff"] < 0.03
    assert res["ks_puck_x"] < 0.06
    assert res["ks_puck_speed"] < 0.06
    close = np.all(np.abs(f_ev.x - f_sw.x) < 1e-3, axis=(1, 2))
    assert close.mean() > 0.95


@pytest.mark.slow
def test_squeeze_impacts_cap_matched(params):
    f_ev, f_sw = _pair("squeeze", params, ref_iters=12, fast_iters=12)
    res = de.compare(f_ev, f_sw, "suite: squeeze sweep12-vs-event12")
    assert res["score_match_rate"] == 1.0
    assert res["damage_rel_diff"] < 0.08
    assert abs(res["damage_z"]) < 3.0


@pytest.mark.slow
def test_stochastic_distributional(params):
    f_ev, f_sw = _pair("uniform", params, seed=23, stochastic=True)
    res = de.compare(f_ev, f_sw, "suite: noise sweep-vs-event")
    assert abs(res["damage_z"]) < 3.5
    assert res["ks_puck_x"] < 0.12
    assert res["ks_puck_speed"] < 0.12


@pytest.mark.slow
def test_corner_grinding_envelope(params):
    f_ev, f_sw = _pair("corner", params, ref_iters=12, fast_iters=12,
                       steps=100)
    res = de.compare(f_ev, f_sw, "suite: corner sweep12-vs-event12 @100")
    assert res["score_match_rate"] > 0.95
    assert abs(res["goals_z"]) < 3.0
    dmg_ev, dmg_sw = res["damage_mean"]
    assert dmg_sw > dmg_ev, res      # the campaign's direction: sweep high
    assert 0.05 < res["damage_rel_diff"] < 0.65, res
