"""The port's event engine (``engine="event"``, plain PyTorch) against the
JAX package's ``physics/engine.py::step`` (jitted under ``vmap``), per
control step from common states in f64, and its semantics: goals and the
puck reset, the elastic swap, decided games frozen (key included), one
game against a batch, and the stochastic mode (noise=0 equal to the
deterministic step, the players' variance against the discrete analytic
covariance).

The port repeats JAX's operations in their order, so the two agree to
roundoff: measured at most 4.4e-16 on random play and 3.8e-14 on corner
pile-ups at the loop cap (49 iterations), held to 1e-9."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics.engine import step as j_step
from robogame_tpu.state import initial_state as j_initial_state

import robogame_tpu_torch as rt
from robogame_tpu_torch.config import A1, A2, B1, B2, PUCK
from robogame_tpu_torch.physics.step import step_event
from robogame_tpu_torch.physics.sweep import _substep_affine_np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from dist_equiv import make_sched, make_states  # noqa: E402
from _port_env import port_module  # noqa: E402,F401  (autouse fixture)

# JAX's initial states (tools/dist_equiv.py), one jitted program: one
# compile instead of one per eager op
_j_make_states = jax.jit(make_states, static_argnums=(0, 1, 2))

B = 8
TOL = 1e-9
JP = JParams(dtype="float64", engine="event")
TP = rt.SimParams(dtype="float64", engine="event")
_j_step_batch = jax.jit(jax.vmap(lambda s, u: j_step(s, u, JP)))


@functools.partial(jax.jit, static_argnums=0)
def _j_states(x0s):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(1, B + 1,
                                                   dtype=jnp.uint32))
    return jax.vmap(lambda k, x0: j_initial_state(JP, x0_puck=x0, seed=k))(
        keys, jnp.asarray(np.array(x0s)))


def _port(s):
    return rt.from_numpy(np.asarray(s.x), np.asarray(s.score),
                         np.asarray(s.damage), np.asarray(s.t),
                         device="cpu", dtype=torch.float64)


def _hold_per_step(sj, controls):
    """At each step, one port step and one JAX step from the same state;
    returns the largest loop iteration count the port ran."""
    deepest = 0
    for u in controls:
        st, iters = step_event(_port(sj), torch.from_numpy(u), TP)
        sj = _j_step_batch(sj, jnp.asarray(u))
        np.testing.assert_array_equal(st.score.numpy(), np.asarray(sj.score))
        assert np.abs(st.x.numpy() - np.asarray(sj.x)).max() <= TOL
        assert np.abs(st.damage.numpy() - np.asarray(sj.damage)).max() <= TOL
        deepest = max(deepest, int(iters.max()))
    return deepest


def test_event_step_matches_jax_random_play():
    """Scoring and bouncy starts (tests/test_pallas_exact.py:64-70) under
    per-game U(-8, 8) controls, 20 steps."""
    x0s = ((3.2, 0.1, 9.0, 0.0),) * (B // 2) + ((0.0, 0.3, 2.0, 1.0),) * (
        B // 2)
    rng = np.random.default_rng(5)
    controls = rng.uniform(-8, 8, (20, B, 4, 2))
    assert _hold_per_step(_j_states(x0s), controls) >= 1


def test_event_step_matches_jax_corner_grinders():
    """Corner pile-ups (tools/dist_equiv.py make_sched("corner")), ground
    20 steps by JAX, then held per step over steps 20-29, which drive the
    loop to its cap."""
    sj = _j_make_states(B, None, JP)
    us = make_sched("corner", B, 30, seed=3).astype(np.float64)
    for u in us[:20]:
        sj = _j_step_batch(sj, jnp.asarray(u))
    assert _hold_per_step(sj, us[20:]) == TP.collision_counter_lim - 1


def _arena(puck):
    x = np.zeros((5, 4))
    x[A1] = [-4, 2, 0, 0]
    x[A2] = [-4, -2, 0, 0]
    x[B1] = [4, 2, 0, 0]
    x[B2] = [4, -2, 0, 0]
    x[PUCK] = puck
    return x


def _state(xs, scores=None):
    xs = np.asarray(xs, np.float64)
    n = xs.shape[0]
    scores = np.zeros((n, 2)) if scores is None else scores
    return rt.from_numpy(xs, scores, np.zeros((n, 4, 4)), np.zeros(n),
                         device="cpu", dtype=torch.float64)


def test_goal_scoring_and_puck_reset():
    """tests/test_engine.py:56 and :68: into the right goal team A scores,
    into the left team B; the puck restarts at rest in the centre."""
    s = _state([_arena([4.80, 0.0, 8.0, 0.0]), _arena([-4.80, 0.2, -8.0,
                                                        0.0])])
    out = rt.step_batch(s, torch.zeros((2, 4, 2), dtype=torch.float64), TP,
                        device="cpu")
    np.testing.assert_array_equal(out.score.numpy(), [[1, 0], [0, 1]])
    np.testing.assert_allclose(out.x[:, PUCK].numpy(), 0.0, atol=1e-12)


def test_head_on_equal_mass_swaps_velocities():
    """tests/test_engine.py:94: equal masses head-on swap x-velocities."""
    x = _arena([0.0, 2.0, 0.0, 0.0])
    x[A1] = [-0.25, 0.0, 2.0, 0.0]
    x[A2] = [0.25, 0.0, -2.0, 0.0]
    u = np.array([[[2.0, 0.0], [-2.0, 0.0], [0.0, 0.0], [0.0, 0.0]]])
    out = rt.step_batch(_state([x]), torch.from_numpy(u), TP, device="cpu")
    vx = out.x[0, :, 2].numpy()
    assert vx[A1] < 0 and vx[A2] > 0
    assert abs(vx[A1] + vx[A2]) < 0.5
    assert out.damage[0, A1, A2] > 0 and out.damage[0, A2, A1] > 0


def test_decided_game_freezes_key_included():
    """tests/test_engine.py:155 in stochastic mode: a decided game keeps
    its whole state, its key included; the undecided one steps and its
    key advances."""
    p = TP.replace(stochastic=True, noise=0.5)
    x = _arena([0.0, 0.0, 1.0, 0.0])
    s = _state([x, x], scores=np.array([[3, 0], [0, 0]]))
    out = rt.step_batch(s, torch.ones((2, 4, 2), dtype=torch.float64), p,
                        device="cpu")
    for new, old in zip(out, s):
        assert torch.equal(new[0], old[0])
    assert float(out.t[1]) == p.dt and not torch.equal(out.x[1], s.x[1])
    np.testing.assert_array_equal(out.key.numpy(), [[0, 0], [1, 1]])


def test_single_matches_batch():
    """tests/test_engine.py:190: ``step`` on one game equals the same game
    in a batch of three, bitwise."""
    x = _arena([2.0, 2.3, 0.0, 3.0])
    x[A1] = [-0.5, 0.0, 3.0, 0.0]
    x[A2] = [0.5, 0.0, -3.0, 0.0]
    u = np.array([[3.0, 0], [-3.0, 0], [0, 0], [0, 0]])
    batch = _state([x, x, x])
    single = rt.step(rt.GameState(*(a[1] for a in batch)), u, TP,
                     device="cpu")
    batched = rt.step_batch(batch, torch.from_numpy(np.stack([u] * 3)), TP,
                            device="cpu")
    for a, b in zip(single, batched):
        assert torch.equal(a, b[1])
    assert float(batched.x[1, PUCK, 3]) < 0      # the puck bounced


def test_noise_zero_matches_deterministic():
    """tests/test_noise.py:90 on the event engine: stochastic with
    noise=0 equals the deterministic step."""
    s = rt.initial_state(TP, x0_puck=[0.0, 0.3, 2.0, 1.0], seed=[1, 2],
                         device="cpu")
    u = torch.ones((2, 4, 2), dtype=torch.float64)
    det = rt.step_batch(s, u, TP, device="cpu")
    sto = rt.step_batch(s, u, TP.replace(stochastic=True, noise=0.0),
                        device="cpu")
    assert torch.equal(det.x, sto.x) and torch.equal(det.damage, sto.damage)


def test_velocity_variance_matches_discrete_analytic():
    """The event row of tests/test_noise.py:65: 256 games x 4 steps at
    noise 0.8, each player component's variance across games within 20%
    of the discrete analytic covariance (the port's own sub-step
    tables)."""
    n_games, n_steps, w = 256, 4, 0.8
    p = TP.replace(stochastic=True, noise=w)
    s = rt.initial_state(p, seed=list(range(1, n_games + 1)), device="cpu")
    u = torch.zeros((n_games, 4, 2), dtype=torch.float64)
    for _ in range(n_steps):
        s = rt.step_batch(s, u, p, device="cpu")
    F, _, L = _substep_affine_np(p)
    C = L @ L.T
    V = np.zeros((4, 4))
    Fp = np.eye(4)
    for _ in range(n_steps * p.grid_points):
        V = V + Fp @ C @ Fp.T
        Fp = F[0] @ Fp
    V = w ** 2 * V
    xs = s.x[:, :4].numpy()
    for c in (2, 3, 0, 1):
        var_m = xs[:, :, c].var(axis=0).mean()
        assert abs(var_m - V[c, c]) / V[c, c] < 0.2, (c, var_m, V[c, c])
