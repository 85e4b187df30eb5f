"""The port's single-game surface and logs: ``GameSim`` with its binary log
against the compiled reference's golden log, the native C++ logger against
the numpy writer (ports of tests/test_native.py), ``monte_carlo(log=True)``
against ``batch_rollout``, and ``rollout`` under a constant policy against
the JAX package's."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics.rollout import rollout as j_rollout
from robogame_tpu.state import initial_state as j_initial_state

import robogame_tpu_torch as rt
from robogame_tpu_torch.native import NativeLogger, available
from robogame_tpu_torch.utils.gamelog import (GameLogWriter, read_log,
                                              write_trajectory_log)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
needs_gxx = pytest.mark.skipif(not available(),
                               reason="no g++ to build the native logger")


def test_gamesim_log_matches_golden(tmp_path):
    """GameSim in f64 (its reset defaults) on kick_goal_10s's schedule:
    its log's first 100 rows are the golden's within 1e-9, and the first
    20 steps through ``scripted_rollout`` and ``write_trajectory_log`` give
    the same rows."""
    name, n = "kick_goal_10s", 100
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        meta = json.load(f)
    sched = np.loadtxt(os.path.join(GOLDEN, f"{name}.sched.txt"))
    sched = sched.reshape(-1, 4, 2)[:n]
    ref = read_log(os.path.join(GOLDEN, f"{name}.log"))[:n]
    sim = rt.GameSim(rt.SimParams(dtype="float64"), device="cpu")
    path = str(tmp_path / "sim.log")
    vec = sim.reset(x0_ball=meta["x0"], log=True, logname=path)
    assert vec.shape == (22,) and sim.log_writer in ("native", "numpy")
    for u in sched:
        vec = sim.run(*u)
    sim.close()
    got = read_log(path)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, 1:3], ref[:, 1:3])
    assert np.abs(got - ref).max() < 1e-9
    np.testing.assert_array_equal(vec[2:4], got[-1, 3:5])   # the puck

    s0 = rt.initial_state(sim.params, x0_puck=meta["x0"], device="cpu")
    _, recs = rt.scripted_rollout(rt.GameState(*(a[0] for a in s0)),
                                  torch.from_numpy(sched[:20]), sim.params,
                                  device="cpu")
    p2 = str(tmp_path / "traj.log")
    write_trajectory_log(p2, recs)
    np.testing.assert_array_equal(read_log(p2), got[:20])


@needs_gxx
def test_native_logger_byte_identical(tmp_path):
    rows = np.random.default_rng(0).normal(size=(37, 29))
    p_native = str(tmp_path / "native.log")
    p_numpy = str(tmp_path / "numpy.log")
    with NativeLogger(p_native) as lg:
        for r in rows:
            lg.write(r)
    with GameLogWriter(p_numpy, native=False) as w:
        assert w.writer == "numpy"
        w.write_rows(rows)
    with open(p_native, "rb") as fa, open(p_numpy, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(read_log(p_native), rows)


@needs_gxx
def test_game_log_writer_prefers_native(tmp_path):
    p = str(tmp_path / "via_writer.log")
    w = GameLogWriter(p)
    assert w.writer == "native"
    w.write_rows(np.arange(58, dtype=np.float64).reshape(2, 29))
    w.close()
    got = read_log(p)
    assert got.shape == (2, 29)
    np.testing.assert_array_equal(got.reshape(-1), np.arange(58))


@needs_gxx
def test_native_flush_visible_before_close(tmp_path):
    p = str(tmp_path / "flush.log")
    lg = NativeLogger(p)
    lg.write(np.ones(29))
    lg.flush()
    assert os.path.getsize(p) == 29 * 8
    lg.close()


def test_monte_carlo_log_matches_batch_rollout():
    """``monte_carlo(log=True)`` returns (result, records (T, B, ...)),
    equal to ``batch_rollout`` of the same initial states and controls."""
    p = rt.SimParams(dtype="float64", winning_score=1)
    mc = rt.McParams(num_runs=4, T=0.5, randomize_x0=True)
    res, recs = rt.monte_carlo(p, mc, log=True, device="cpu")
    T = recs.t.shape[0]
    assert T == 10 and recs.positions.shape == (T, 4, 5, 2)
    from robogame_tpu_torch.parallel.monte_carlo import _initial_states
    s0 = _initial_states(p, mc, device="cpu")
    fin, ref = rt.batch_rollout(s0, torch.zeros((T, 4, 4, 2),
                                                dtype=torch.float64), p,
                                log=True, device="cpu")
    for a, b in zip(recs, ref):
        assert torch.equal(a, b)
    assert torch.equal(res.scores, fin.score)
    assert torch.equal(recs.score[-1], res.scores)


def test_rollout_constant_policy_matches_jax():
    """``rollout`` under a constant policy (with a step counter as its
    state) against the JAX package's ``rollout``, f64, 12 steps: scores
    equal, positions and damage within 1e-9."""
    n = 12
    u = np.array([[6.0, 1.0], [5.0, -2.0], [-6.0, 0.5], [-4.0, -1.0]])
    x0 = [4.0, 0.0, 6.0, 0.0]           # into the right goal
    jp = JParams(dtype="float64")
    js = j_initial_state(jp, x0_puck=x0)
    _, jk, jrecs = jax.jit(lambda s: j_rollout(
        s, lambda k, st: (k + 1, jnp.asarray(u)), jp, n, log=True,
        policy_state=jnp.asarray(0)))(js)
    tp = rt.SimParams(dtype="float64")
    ts = rt.GameState(*(a[0] for a in rt.initial_state(tp, x0_puck=x0,
                                                       device="cpu")))
    fin, tk, recs = rt.rollout(ts, lambda k, st: (k + 1, u), tp, n,
                               log=True, policy_state=0, device="cpu")
    assert tk == int(jk) == n and fin.x.shape == (5, 4)
    np.testing.assert_array_equal(recs.score.numpy(),
                                  np.asarray(jrecs.score))
    for mine, ref in ((recs.positions, jrecs.positions),
                      (recs.damage, jrecs.damage)):
        assert np.abs(mine.numpy() - np.asarray(ref)).max() < 1e-9
    assert tuple(recs.score[-1].tolist()) == (1, 0)
