"""The port's sweep engine (``engine="sweep"``, plain PyTorch) against the
JAX package's ``step_sweep`` (its XLA program under ``vmap``), per control
step from common states, and its batching: decided games frozen, a game
whose event loop ended keeps its carry while others loop.

The port writes out JAX's batched algebra (the populate and the tails as
elementwise products and sums where JAX takes einsums), so the two agree
to roundoff: measured at most 4.5e-16 in f64 and 2.4e-7 in f32 over 25
steps of random play and corner pile-ups (damage equal), held here to
1e-12 and 1e-5.  Scores are exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics.engine import _detect as j_detect
from robogame_tpu.physics.sweep import step_sweep as j_step_sweep
from robogame_tpu.state import initial_state as j_initial_state

import robogame_tpu_torch as rt
from robogame_tpu_torch.physics.engine import _detect
from robogame_tpu_torch.physics.sweep import _affine_tables
from _port_env import port_module  # noqa: F401  (autouse fixture)

B, HALF = 16, 8
# scoring runs and bouncy runs (tests/test_pallas.py:29-48), then corner
# pile-ups (tests/test_pallas.py:152-172: every player driven at (-8, -8))
X0S = np.concatenate([np.tile([3.2, 0.1, 9.0, 0.0], (HALF // 2, 1)),
                      np.tile([0.0, 0.3, 2.0, 1.0], (HALF // 2, 1)),
                      np.tile([0.0, 0.0, -3.0, -1.5], (HALF, 1))])
TOL = {"float64": 1e-12, "float32": 1e-5}


def _controls(rng, dtype):
    u = rng.uniform(-8, 8, (B, 4, 2))
    u[HALF:] = -8.0
    return u.astype(dtype)


@functools.partial(jax.jit, static_argnums=0)
def _j_states(jp):
    """JAX's initial states (one jitted program, not one per eager op)."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(1, B + 1,
                                                   dtype=jnp.uint32))
    return jax.vmap(lambda k, x0: j_initial_state(jp, x0_puck=x0, seed=k))(
        keys, jnp.asarray(X0S, jp.jdtype))


def _port(s, tp):
    return rt.from_numpy(np.asarray(s.x), np.asarray(s.score),
                         np.asarray(s.damage), np.asarray(s.t),
                         device="cpu", dtype=tp.torch_dtype)


def test_detect_matches_jax_on_random_grids():
    """Random states populated in closed form (f64), random bases and
    start times; the entities crowd a 3 x 2 box so pairs and walls both
    fire."""
    p = rt.SimParams(dtype="float64")
    jp = JParams(dtype="float64")
    n = 24
    rng = np.random.default_rng(11)
    x = np.zeros((n, 5, 4))
    x[:, :, 0] = rng.uniform(-1.5, 1.5, (n, 5)) + rng.choice([-3.2, 3.2],
                                                              (n, 1))
    x[:, :, 1] = rng.uniform(-1.0, 1.0, (n, 5)) + rng.choice([-1.3, 1.3],
                                                              (n, 1))
    x[:, :, 2:] = rng.uniform(-8, 8, (n, 5, 2))
    u = np.concatenate([rng.uniform(-8, 8, (n, 4, 2)), np.zeros((n, 1, 2))],
                       axis=1)
    Fpow, Spow, _ = _affine_tables(p, "cpu")
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    grid = ((Fpow[None] * xt[:, None, :, None, :]).sum(-1)
            + (Spow[None] * ut[:, None, :, None, :]).sum(-1))
    base = rng.integers(1, p.grid_points + 1, (n, 5))
    t0 = rng.uniform(0.0, 5.0, n)
    mine = _detect(grid, torch.from_numpy(base), torch.from_numpy(t0), p,
                   torch.tensor(p.radii, dtype=torch.float64))
    ref = jax.jit(jax.vmap(lambda g, b, t: j_detect(
        g, b, t, jp, jnp.asarray(jp.radii))))(
        jnp.asarray(grid.numpy()), jnp.asarray(base, jnp.int32),
        jnp.asarray(t0))
    valid = np.asarray(ref.valid)
    assert valid.sum() >= 20 and (np.asarray(ref.ctype)[valid] == 4).any()
    np.testing.assert_array_equal(mine.valid.numpy(), valid)
    np.testing.assert_array_equal(mine.j.numpy(), np.asarray(ref.j))
    np.testing.assert_array_equal(mine.ctype.numpy(), np.asarray(ref.ctype))
    np.testing.assert_allclose(mine.t.numpy(), np.asarray(ref.t), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_sweep_matches_jax_per_step(dtype):
    jp = JParams(dtype=dtype, engine="sweep")
    tp = rt.SimParams(dtype=dtype, engine="sweep")
    step_j = jax.jit(jax.vmap(lambda s, u: j_step_sweep(s, u, jp)))
    s = _j_states(jp)
    rng = np.random.default_rng(5)
    for _ in range(25):
        u = _controls(rng, np.dtype(dtype))
        sj = step_j(s, jnp.asarray(u))
        st = rt.step_sweep(_port(s, tp), torch.from_numpy(u), tp)
        np.testing.assert_array_equal(st.score.numpy(), np.asarray(sj.score))
        assert np.abs(st.x.numpy() - np.asarray(sj.x)).max() <= TOL[dtype]
        assert np.abs(st.damage.numpy() -
                      np.asarray(sj.damage)).max() <= TOL[dtype]
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(sj.t))
        s = sj
    assert int(np.asarray(s.score).sum()) > 0          # goals were scored
    assert float(np.asarray(s.damage)[HALF:].sum()) > 1.0  # players collided


@pytest.mark.parametrize("engine, dtype", [("sweep", "float64"),
                                           ("pallas", "float32")])
def test_decided_games_are_frozen(engine, dtype):
    """Through ``step_batch``: the sweep engine, and K6's plain version."""
    tp = rt.SimParams(dtype=dtype, engine=engine, winning_score=3)
    s = rt.initial_state(tp, x0_puck=torch.tensor(X0S), seed=list(range(B)),
                         device="cpu")
    score = s.score.clone()
    score[::2, 0] = 3                           # even games are decided
    s = s._replace(score=score)
    rng = np.random.default_rng(2)
    s1 = s
    for _ in range(3):
        s1 = rt.step_batch(s1, torch.from_numpy(_controls(rng, dtype)), tp,
                           device="cpu")
    for a, b in zip(s1[:4], s[:4]):
        torch.testing.assert_close(a[::2], b[::2], rtol=0, atol=0)
    assert not torch.equal(s1.x[1::2], s.x[1::2])
    torch.testing.assert_close(s1.t[1::2], s.t[1::2] + 3 * tp.dt)


def test_finished_game_keeps_its_carry_while_others_loop():
    """Each game of the batch equals the same game stepped alone, bitwise:
    the loop runs while any game has a valid slot, and the games whose
    slots ran out (the quiet random-play games, while the pile-ups grind)
    keep their carry."""
    tp = rt.SimParams(dtype="float64", engine="sweep")
    s = rt.initial_state(tp, x0_puck=torch.tensor(X0S), seed=list(range(B)),
                         device="cpu")
    rng = np.random.default_rng(9)
    for _ in range(18):
        u = torch.from_numpy(_controls(rng, np.float64))
        s_next = rt.step_sweep(s, u, tp)
        for b in (0, 4, HALF, B - 1):
            one = rt.step_sweep(type(s)(*(a[b:b + 1] for a in s)),
                                u[b:b + 1], tp)
            for a, o in zip(s_next[:4], one[:4]):
                assert torch.equal(a[b:b + 1], o), b
        s = s_next
    assert float(s.damage[HALF:].sum()) > 0.0          # the pile-ups met
