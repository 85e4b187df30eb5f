"""The port's event engine against the compiled reference's golden logs
(tests/golden/, the reference GameSim driven with scripted velocity
schedules), through the port's ``scripted_rollout`` in f64 on the CPU, at
the levels of tests/test_parity.py: scores exactly equal at every control
step, positions within 1e-9 over the first 100 steps, and the full runs
within that file's ``FULL_RUN_TOL`` (marked slow).  Scenarios that share
their params run as one batch.

Measured on the CPU: the first 100 steps of all nine scenarios equal the
goldens bitwise, and so do the full runs of all but kick_goal_10s (its
players grind along the walls from about step 150; 0.527 at most)."""

import json
import os

import numpy as np
import pytest
import torch

from test_parity import FULL_RUN_TOL

import robogame_tpu_torch as rt
from robogame_tpu_torch.utils.gamelog import damage_log_fields, read_log

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCENARIOS = [s[:-5] for s in sorted(os.listdir(GOLDEN))
             if s.endswith(".json")]
EARLY = 100


def _meta(name):
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        return json.load(f)


def _params(meta):
    return rt.SimParams(
        dt=meta["dt"], winning_score=meta.get("winning_score", 100),
        tau_puck=meta.get("tau_puck", 0.1),
        tau_player=meta.get("tau_player", 0.5),
        player_mass=meta.get("player_mass", 1.0),
        puck_mass=meta.get("puck_mass", 0.5), dtype="float64")


def _groups():
    """{params: [scenario names]}, in the scenarios' order."""
    groups = {}
    for name in SCENARIOS:
        groups.setdefault(_params(_meta(name)), []).append(name)
    return groups


GROUPS = list(_groups().items())


# the early windows' rollouts, (parts, states at segment ends, state at
# EARLY) by group: a full run resumes from its group's window (the state is
# the whole carry, so that equals one rollout from the start, bitwise)
_EARLY_RUNS = {}


def _run_group(params, names, n_steps=None):
    """The group's scenarios as one batch, each on its own schedule (zero
    controls past its end) for ``n_steps`` (default: the longest), rolled
    out in segments that end at each scenario's last step and at EARLY.
    Returns the stacked records (T, B, ...) and each scenario's state at
    its own last step (the whole batch's)."""
    metas = [_meta(n) for n in names]
    T = max(m["n_steps"] for m in metas) if n_steps is None else n_steps
    u = np.zeros((T, len(names), 4, 2))
    for i, name in enumerate(names):
        sched = np.loadtxt(os.path.join(GOLDEN, f"{name}.sched.txt"))
        sched = sched.reshape(-1, 4, 2)[:T]
        u[:len(sched), i] = sched
    u = torch.from_numpy(u)
    s = rt.initial_state(params, x0_puck=np.array([m["x0"] for m in metas],
                                                  np.float64), device="cpu")
    ends = sorted({min(m["n_steps"], T) for m in metas} | {T}
                  | ({EARLY} if T > EARLY else set()))
    parts, at_end, done = [], {}, 0
    key = (params, tuple(names))
    if T >= EARLY and key in _EARLY_RUNS:
        early_parts, early_ends, s = _EARLY_RUNS[key]
        parts, at_end, done = list(early_parts), dict(early_ends), EARLY
    for end in ends:
        if end <= done:
            continue
        s, recs = rt.scripted_rollout(s, u[done:end], params, device="cpu")
        parts.append(recs)
        at_end[end] = s
        done = end
        if end == EARLY:
            _EARLY_RUNS[key] = (list(parts), dict(at_end), s)
    recs = rt.LogRecord(*(torch.cat(f) for f in zip(*parts)))
    finals = [at_end[min(m["n_steps"], T)] for m in metas]
    return recs, finals


def _hold(name, recs, i, n_steps):
    """Scenario ``name`` (batch row i of recs) against its golden log over
    its first n_steps logged steps; returns the position errors of the
    first EARLY steps and of all of them, and the log's length."""
    ref = read_log(os.path.join(GOLDEN, f"{name}.log"))
    n = min(n_steps, ref.shape[0])   # the reference stops logging when
    pos = recs.positions[:n, i].reshape(n, 10).numpy()   # decided
    np.testing.assert_allclose(recs.t[:n, i].numpy(), ref[:n, 0],
                               atol=1e-12)
    np.testing.assert_array_equal(recs.score[:n, i].numpy(),
                                  ref[:n, 1:3].astype(np.int64),
                                  err_msg=f"{name}: score mismatch")
    k = min(EARLY, n)
    early = np.abs(pos[:k] - ref[:k, 3:13]).max()
    return early, np.abs(pos - ref[:n, 3:13]).max(), ref, n


@pytest.mark.parametrize("params,names", GROUPS,
                         ids=["+".join(n) for _, n in GROUPS])
def test_golden_early_window(params, names):
    """Scores exact and positions within 1e-9 over the first 100 steps."""
    recs, _ = _run_group(params, names, EARLY)
    for i, name in enumerate(names):
        early, _, _, _ = _hold(name, recs, i, EARLY)
        assert early < 1e-9, f"{name}: early-window err {early}"


def test_decided_game_freezes_and_stops_logging(tmp_path):
    """winning_score_1 run to its end (tests/test_parity.py:107): the
    golden has only 4 records because the reference stops physics and
    logging once decided; the rollout freezes from there, and GameSim's
    log stops there, its rows the golden's."""
    name = "winning_score_1"
    meta = _meta(name)
    params = _params(meta)
    recs, _ = _run_group(params, [name])
    _, _, ref, n = _hold(name, recs, 0, meta["n_steps"])
    assert n == ref.shape[0] < meta["n_steps"]
    frozen = recs.positions[n - 1:, 0]
    assert bool((frozen == frozen[0]).all())
    assert tuple(recs.score[-1, 0].tolist()) == (1, 0)

    sched = np.loadtxt(os.path.join(GOLDEN, f"{name}.sched.txt"))
    sim = rt.GameSim(params, device="cpu")
    path = str(tmp_path / "ws1.log")
    sim.reset(dt=meta["dt"], winning_score=1, x0_ball=meta["x0"], log=True,
              logname=path)
    for u in sched.reshape(-1, 4, 2)[:n + 3]:
        sim.run(*u)
    assert not sim.undecided()
    sim.close()
    np.testing.assert_allclose(read_log(path), ref, rtol=0, atol=1e-9)


@pytest.mark.slow
def test_golden_full_runs():
    """The full runs of every group within FULL_RUN_TOL; damage and the
    final vector where that bound is below 1e-3 (tests/test_parity.py:
    93-104).  About 105 s on one CPU core."""
    for params, names in GROUPS:
        recs, finals = _run_group(params, names)
        for i, name in enumerate(names):
            meta = _meta(name)
            early, err, ref, n = _hold(name, recs, i, meta["n_steps"])
            assert early < 1e-9, f"{name}: early-window err {early}"
            assert err < FULL_RUN_TOL[name], f"{name}: position err {err}"
            if FULL_RUN_TOL[name] < 1e-3:
                dmg = damage_log_fields(recs.damage[:n, i].numpy())
                assert np.abs(dmg - ref[:, 13:29]).max() < 1e-3, name
                final = np.fromfile(
                    os.path.join(GOLDEN, f"{name}.log.final"), dtype="<f8")
                vec = rt.to_vector(finals[i])[i].numpy()
                np.testing.assert_allclose(vec, final, atol=1e-3,
                                           err_msg=name)
