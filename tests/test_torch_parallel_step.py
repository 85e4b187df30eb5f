"""The port's parallel-resolution step (``engine="pallas"``; on CPU tensors
the plain PyTorch version of K6) against the JAX package: its Pallas K6 in
interpret mode (one compile in this file), and its XLA ``step_sweep``.

Measured (CPU, f32, per control step from common states): against JAX's
K6 at most 2.4e-7 in x on random play and, on corner pile-ups, 4.8e-7
over 16 games and 3.5e-5 over 128 games (a probe at the default params),
with damage equal; against JAX's ``step_sweep`` 2.4e-7 on random play.  The
populate and the tails sum the six non-zeros of M where JAX takes 32-term
dots, so the two differ in f32 roundoff only; held here to JAX's own
tolerances (tests/test_pallas.py:44-48): x 1e-4, damage 1e-5, scores
exact, and each game's activity (``with_activity``: the loop iterations
with a live event) exact.  The activity-sorted rollout equals the
step-by-step one bitwise.  K6 is not bitwise equal to the sweep engine:
it re-detects every entity each iteration where the sweep engine keeps
the slots of untouched entities, and it re-propagates through z =
Finvpow[base] (x_base - Spow u) where the sweep engine applies
Fpow[k - base] to x_base."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics.pallas_step import step_pallas_batch
from robogame_tpu.physics.sweep import step_sweep as j_step_sweep
from robogame_tpu.state import initial_state as j_initial_state

import robogame_tpu_torch as rt
from robogame_tpu_torch.parallel.monte_carlo import _initial_states
from robogame_tpu_torch.physics import exact_step as ex
from robogame_tpu_torch.physics import parallel_step as ps
from robogame_tpu_torch.physics.sweep import _substep_affine_np
from _port_env import port_module  # noqa: F401  (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from dist_equiv import make_sched  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
JP = JParams(dtype="float32", engine="pallas", two_phase=False)
TP = rt.SimParams(dtype="float32", engine="pallas", two_phase=False)
X_TOL, DMG_TOL = 1e-4, 1e-5

RANDOM_X0 = np.concatenate([np.tile([3.2, 0.1, 9.0, 0.0], (4, 1)),   # scoring
                            np.tile([0.0, 0.3, 2.0, 1.0], (4, 1))])  # bouncy


def _j_states(jp, x0s):
    return _j_states_jit(jp, jnp.asarray(x0s, jnp.float32))


@functools.partial(jax.jit, static_argnums=0)
def _j_states_jit(jp, x0s):
    """JAX's initial states of games seeded 1..B, one jitted program (one
    compile instead of one per eager op)."""
    keys = jax.vmap(jax.random.PRNGKey)(
        jnp.arange(1, x0s.shape[0] + 1, dtype=jnp.uint32))
    return jax.vmap(lambda k, x0: j_initial_state(jp, x0_puck=x0, seed=k))(
        keys, x0s)


def _port(s):
    return rt.from_numpy(np.asarray(s.x), np.asarray(s.score),
                         np.asarray(s.damage), np.asarray(s.t), device="cpu")


def _held(sj, st):
    np.testing.assert_array_equal(st.score.numpy(), np.asarray(sj.score))
    assert np.abs(st.x.numpy() - np.asarray(sj.x)).max() <= X_TOL
    assert np.abs(st.damage.numpy() - np.asarray(sj.damage)).max() <= DMG_TOL
    np.testing.assert_array_equal(st.t.numpy(), np.asarray(sj.t))


def test_plain_k6_matches_jax_interpret_mode():
    """The file's one interpret-mode compile: 8 random-play games (scoring
    and bouncy runs) and 8 corner pile-ups (every player driven at
    (-8, -8), tests/test_pallas.py:152-172), 18 steps."""
    x0s = np.concatenate([RANDOM_X0, np.tile([0.0, 0.0, -3.0, -1.5],
                                             (8, 1))])
    s = _j_states(JP, x0s)
    rng = np.random.default_rng(5)
    for _ in range(18):
        u = rng.uniform(-8, 8, (16, 4, 2)).astype(np.float32)
        u[8:] = -8.0
        sj, aj = step_pallas_batch(s, jnp.asarray(u), JP,
                                   with_activity=True)
        st, at = rt.step_batch(_port(s), torch.from_numpy(u), TP,
                               device="cpu", with_activity=True)
        _held(sj, st)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        s = sj
    assert int(np.asarray(s.score).sum()) > 0          # goals were scored
    assert float(np.asarray(s.damage)[8:].sum()) > 1.0  # the pile-ups met


def test_plain_k6_matches_jax_sweep_random_play():
    jp = JP.replace(engine="sweep")
    step_j = jax.jit(jax.vmap(lambda s, u: j_step_sweep(s, u, jp)))
    s = _j_states(JP, RANDOM_X0)
    rng = np.random.default_rng(5)
    for _ in range(25):
        u = rng.uniform(-8, 8, (8, 4, 2)).astype(np.float32)
        sj = step_j(s, jnp.asarray(u))
        st = rt.step_batch(_port(s), torch.from_numpy(u), TP, device="cpu")
        _held(sj, st)
        s = sj
    assert int(np.asarray(s.score).sum()) > 0


def test_golden_kick_goal_scores_match_jax_sweep():
    """The golden kick schedule (one game, 200 steps): K6's scores equal
    JAX's step_sweep at every control step (tests/test_pallas.py:51-72)."""
    name = "kick_goal_10s"
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        meta = json.load(f)
    sched = np.loadtxt(os.path.join(GOLDEN, f"{name}.sched.txt"))
    sched = sched.reshape(-1, 1, 4, 2).astype(np.float32)
    jp = JParams(dt=meta["dt"], winning_score=100, dtype="float32",
                 engine="sweep")
    tp = TP.replace(dt=meta["dt"], winning_score=100)
    step_j = jax.jit(jax.vmap(lambda s, u: j_step_sweep(s, u, jp)))
    sj = _j_states(jp, [meta["x0"]])
    st = rt.initial_state(tp, x0_puck=meta["x0"], device="cpu")
    for k in range(meta["n_steps"]):
        sj = step_j(sj, jnp.asarray(sched[k]))
        st = rt.step_batch(st, torch.from_numpy(sched[k]), tp, device="cpu")
        np.testing.assert_array_equal(st.score.numpy(), np.asarray(sj.score))
    assert np.isfinite(st.x.numpy()).all()


def _mc_states(B):
    return _initial_states(rt.SimParams(),
                           rt.McParams(num_runs=B, randomize_x0=True),
                           device="cpu")


def _corner_pinned(B):
    """tests/test_pallas.py:190-212: each player pinned into its own corner
    by the schedule -- alternating wall events at every grid point."""
    s = rt.initial_state(TP, seed=list(range(1, B + 1)), device="cpu")
    x = s.x.clone()
    u = torch.zeros((B, 4, 2))
    for p, (sx, sy) in enumerate([(-1, -1), (-1, 1), (1, -1), (1, 1)]):
        x[:, p] = torch.tensor([4.81 * sx, 2.31 * sy, 0.01 * sx, 0.01 * sy])
        u[:, p] = torch.tensor([8.0 * sx, 8.0 * sy])
    return s._replace(x=x), [u] * 4


@pytest.mark.parametrize("path", ["compact", "overflow"])
def test_twophase_bitwise_equals_one_phase(monkeypatch, path):
    """Two-phase (export at phase1_iters=1, gather the pending games into
    K lanes, resume, scatter) equals the one-phase step bitwise, its
    activity (meta row 3) included.  B=256:
    the compacted path at compact_frac=4 (K=64 >= pending), the overflow
    path at compact_frac=2 (K=128 < pending: full-batch resume)."""
    B = 256
    if path == "compact":
        us = torch.from_numpy(make_sched("uniform", B, 26, seed=5))
        s = _mc_states(B)
        for u in us[:20]:                    # into the game: events pend
            s = rt.step_batch(s, u, TP, device="cpu")
        us = us[20:]
        frac = 4
    else:
        s, us = _corner_pinned(B)
        frac = 2
    p2 = TP.replace(two_phase=True, phase1_iters=1, compact_frac=frac)
    resumes, pending = [], []
    call = ps._kernel_call

    def spy(planes, *a, **kw):
        out = call(planes, *a, **kw)
        if kw.get("mode") == "resume":
            resumes.append(planes[0].shape[1])
        if kw.get("mode") == "export":
            pending.append(int(out[0][1][5].sum()))
        return out

    monkeypatch.setattr(ps, "_kernel_call", spy)
    s1 = s2 = s
    for u in us:
        s1, a1 = rt.step_batch(s1, u, TP, device="cpu", with_activity=True)
        s2, a2 = rt.step_batch(s2, u, p2, device="cpu", with_activity=True)
        for a, b in zip((*s1, a1), (*s2, a2)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    K = ex._compact_lanes(B, p2)
    if path == "compact":
        assert K == 64 and resumes == [K] * len(us) and \
            0 < max(pending) <= K
    else:
        assert K == 128 and pending[0] > K and B in resumes


def test_stochastic_velocity_std_matches_analytic():
    """With zero input and no collisions the player velocity variance
    after m sub-steps is sum_j F^j C F^j' (C = w^2 L L', the per-substep
    noise covariance); 4096 samples, a 6% band (tests/test_pallas.py:
    75-105).  K6 and the sweep engine draw the same populate noise."""
    B, n = 512, 8
    p = TP.replace(stochastic=True, noise=0.8)
    F, _, L = _substep_affine_np(p)
    C = (p.noise ** 2) * (L @ L.T)
    V = np.zeros((4, 4))
    for _ in range(n * p.grid_points):
        V = F[0] @ V @ F[0].T + C
    sig_v = np.sqrt(V[2, 2])
    u = torch.zeros((B, 4, 2))
    for engine in ("pallas", "sweep"):
        pe = p.replace(engine=engine)
        s = rt.initial_state(pe, seed=list(range(1, B + 1)), device="cpu")
        for _ in range(n):
            s = rt.step_batch(s, u, pe, device="cpu")
        v = s.x[:, :4, 2:4].numpy()
        rel = abs(v.std() - sig_v) / sig_v
        assert rel < 0.06, (engine, v.std(), sig_v, rel)
        assert torch.equal(s.key[:, 1], torch.full((B,), n))


def test_odd_batch_noise0_and_activity():
    """B=3 steps; stochastic with noise=0 equals the deterministic step
    bitwise; activity (meta row 3) is zero for drifting games and positive
    for a game whose puck is fired at a player (tests/test_pallas.py:
    241-258)."""
    s = rt.initial_state(TP, seed=[0, 1, 2], device="cpu")
    out = rt.step_batch(s, torch.zeros((3, 4, 2)), TP, device="cpu")
    assert out.x.shape == (3, 5, 4) and torch.isfinite(out.x).all()

    u8 = torch.tensor([[8., 0.], [8., 0.], [-8., 0.], [-8., 0.]])
    for tp in (False, True):
        pd = TP.replace(two_phase=tp)
        sd = ss = rt.initial_state(pd, x0_puck=[0., 0., 6., 0.2],
                                   seed=list(range(8)), device="cpu")
        for _ in range(3):
            sd = rt.step_batch(sd, u8.repeat(8, 1, 1), pd, device="cpu")
            ss = rt.step_batch(ss, u8.repeat(8, 1, 1), pd.replace(
                stochastic=True, noise=0.0), device="cpu")
        for a, b in zip(sd[:4], ss[:4]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    x0s = np.zeros((4, 4))
    x0s[0] = [2.0, 1.25, 6.0, 0.0]
    s = rt.initial_state(TP, x0_puck=torch.tensor(x0s, dtype=torch.float32),
                         seed=list(range(4)), device="cpu")
    act = torch.zeros(4)
    for _ in range(6):
        s, a = rt.step_batch(s, torch.zeros((4, 4, 2)), TP, device="cpu",
                             with_activity=True)
        act += a
    assert act[0] > 0 and act[1:].sum() == 0


def test_monte_carlo_pallas_matches_sweep():
    """tests/test_monte_carlo.py:101-117: 16 games, T=0.5, the two fast
    engines give the same games."""
    mc = rt.McParams(num_runs=16, T=0.5, randomize_x0=True)
    res_pl = rt.monte_carlo(TP.replace(two_phase=True), mc, device="cpu")
    res_sw = rt.monte_carlo(TP.replace(engine="sweep"), mc, device="cpu")
    np.testing.assert_array_equal(res_pl.scores.numpy(),
                                  res_sw.scores.numpy())
    np.testing.assert_allclose(res_pl.damage.numpy(), res_sw.damage.numpy(),
                               rtol=0, atol=1e-5)


def test_dispatch_and_device():
    """Engine 'event' runs on CPU tensors; the default device is the
    card, so without one the step and the sorted rollout raise rather than
    running on the CPU; on CPU tensors engine 'pallas' runs the plain
    version (no K6 launch); the engines without a kernel have no activity
    and no sorted rollout."""
    from robogame_tpu_torch import kernels
    s = rt.initial_state(TP, seed=[1, 2], device="cpu")
    u = torch.zeros((2, 4, 2))
    ev = rt.step_batch(s, u, TP.replace(engine="event"), device="cpu")
    assert ev.x.device.type == "cpu" and bool(torch.isfinite(ev.x).all())
    for engine in ("event", "sweep"):
        pe = TP.replace(engine=engine)
        with pytest.raises(ValueError, match="kernel engine"):
            rt.step_batch(s, u, pe, device="cpu", with_activity=True)
        with pytest.raises(ValueError, match="kernel engine"):
            rt.rollout_pallas_sorted(s, u[None], pe, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.step_batch(s, u, TP)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.rollout_pallas_sorted(s, u[None], TP)
    kernels.reset_launches()
    rt.step_batch(s, u, TP.replace(two_phase=True), device="cpu")
    assert sum(kernels.parallel_launches.values()) == 0


def _sort_inputs(params, B=12, n=8):
    """tests/test_pallas.py:221-239's shape: B=12 random pucks, faster
    here, two of them fired at players, 8 steps of U(-8, 8) controls."""
    rng = np.random.default_rng(3)
    x0s = rng.uniform(-1, 1, (B, 4)) * np.array([4.5, 2.2, 10.0, 10.0])
    x0s[:2] = [[2.0, 1.25, 6.0, 0.0], [-2.0, -1.25, -6.0, 0.0]]
    s = rt.initial_state(params,
                         x0_puck=torch.tensor(x0s, dtype=torch.float32),
                         seed=list(range(1, B + 1)), device="cpu")
    us = torch.from_numpy(rng.uniform(-8, 8, (n, B, 4, 2)).astype(np.float32))
    us[:, :2] = 0.0
    return s, us


@pytest.mark.parametrize("two_phase, stochastic, every", [
    (False, False, 2), (True, False, 1), (False, True, 2)])
def test_sorted_rollout_equals_step_by_step(two_phase, stochastic, every):
    """rollout_pallas_sorted on K6's plain version equals the one-phase
    step-by-step rollout bitwise (keys included), one- and two-phase, at
    resort_every 1 and 2, deterministic and stochastic; the games'
    activities differ, so the sort permutes them."""
    p1 = TP.replace(stochastic=stochastic, noise=1.0 if stochastic else 0.0)
    s, us = _sort_inputs(p1)
    ref, act = s, torch.zeros(s.score.shape[0])
    for u in us:
        ref, a = rt.step_batch(ref, u, p1, device="cpu", with_activity=True)
        act += a
    assert act.max() > 0 and (act == 0).any()
    got = rt.rollout_pallas_sorted(s, us, p1.replace(two_phase=two_phase),
                                   resort_every=every, device="cpu")
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

