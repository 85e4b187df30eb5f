"""The port's batched exact step (the plain PyTorch version of K1, which is
what runs on CPU tensors) against the JAX package's ``step_pallas_batch``
in interpret mode, per step from common states.

Tolerances are those of tests/test_pallas_exact.py.  The two sides differ
only in f32 roundoff: the populate sums the 6 non-zeros of M where JAX
takes a 32-term dot.  Random play keeps chains short, so states agree to
1e-4; corner grinding drives the event loop to its cap and amplifies
roundoff within a step (x 5e-3, damage 2e-3).  Scores are exact."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.physics.pallas_step import step_pallas_batch
from robogame_tpu.state import initial_state as j_initial_state

import robogame_tpu_torch as rt

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from dist_equiv import make_sched, make_states  # noqa: E402

JP = JParams(dtype="float32", engine="pallas_exact")
TP = rt.SimParams(dtype="float32", engine="pallas_exact")


def _port(s):
    return rt.from_numpy(np.asarray(s.x), np.asarray(s.score),
                         np.asarray(s.damage), np.asarray(s.t),
                         device="cpu")


def _step_both(s, u):
    """One step of each side from the JAX state ``s``."""
    sj = step_pallas_batch(s, jnp.asarray(u), JP)
    st = rt.step_batch(_port(s), torch.as_tensor(np.asarray(u)), TP,
                       device="cpu")
    return sj, st


@jax.jit
def _j_states(x0s):
    """JAX's initial states of games seeded 1..B with the puck at x0s, one
    jitted program (one compile instead of one per eager op)."""
    keys = jax.vmap(jax.random.PRNGKey)(
        jnp.arange(1, x0s.shape[0] + 1, dtype=jnp.uint32))
    return jax.vmap(lambda k, x0: j_initial_state(JP, x0_puck=x0, seed=k))(
        keys, x0s)


def test_random_play_per_step_matches_jax():
    B = 16          # the corner test's batch: one compile of the JAX step
    rng = np.random.default_rng(5)
    x0s = np.concatenate([np.tile([3.2, 0.1, 9.0, 0.0], (B // 2, 1)),
                          np.tile([0.0, 0.3, 2.0, 1.0], (B // 2, 1))])
    s = _j_states(jnp.asarray(x0s, jnp.float32))
    goals = 0
    for _ in range(20):
        u = rng.uniform(-8, 8, (B, 4, 2)).astype(np.float32)
        sj, st = _step_both(s, u)
        np.testing.assert_array_equal(st.score.numpy(), np.asarray(sj.score))
        np.testing.assert_allclose(st.damage.numpy(), np.asarray(sj.damage),
                                   rtol=0, atol=1e-4)
        assert np.abs(st.x.numpy() - np.asarray(sj.x)).max() < 1e-4
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(sj.t))
        s = sj
        goals = int(np.asarray(sj.score).sum())
    assert goals > 0        # the goal test and the scored latch ran


def test_corner_grinding_per_step_matches_jax():
    """Corner pile-ups, pre-ground by the JAX step, then 10 steps each
    taken by both sides from the same JAX state."""
    B = 16
    us = make_sched("corner", B, 40, seed=3)
    s = make_states(B, None, JParams(dtype="float32", engine="event"))
    for k in range(28):
        s = step_pallas_batch(s, jnp.asarray(us[k]), JP)
    dmg0 = float(np.asarray(s.damage).sum())
    for k in range(28, 38):
        sj, st = _step_both(s, us[k])
        np.testing.assert_array_equal(st.score.numpy(), np.asarray(sj.score))
        np.testing.assert_allclose(st.damage.numpy(), np.asarray(sj.damage),
                                   rtol=2e-3, atol=2e-3)
        dx = np.abs(st.x.numpy() - np.asarray(sj.x)).max()
        assert dx < 5e-3, (k, dx)
        s = sj
    assert float(np.asarray(s.damage).sum()) > dmg0   # players collided


def test_stochastic_noise0_bitwise_equals_deterministic():
    """stochastic=True with noise=0 equals the deterministic step bitwise,
    one- and two-phase (plumbing of both noise planes)."""
    B = 8
    u = torch.tensor([[8., 0.], [8., 0.], [-8., 0.], [-8., 0.]]).repeat(
        B, 1, 1)
    for tp in (False, True):
        pd = TP.replace(two_phase=tp)
        ps = pd.replace(stochastic=True, noise=0.0)
        sd = rt.initial_state(pd, x0_puck=[0., 0., 6., 0.2],
                              seed=list(range(B)), device="cpu")
        ss = sd
        for _ in range(3):
            sd = rt.step_batch(sd, u, pd, device="cpu")
            ss = rt.step_batch(ss, u, ps, device="cpu")
        torch.testing.assert_close(sd.x, ss.x, rtol=0, atol=0)
        torch.testing.assert_close(sd.damage, ss.damage, rtol=0, atol=0)
        torch.testing.assert_close(sd.score, ss.score, rtol=0, atol=0)
