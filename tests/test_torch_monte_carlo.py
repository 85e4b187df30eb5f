"""The port's Monte-Carlo sweep against the JAX package's: the same
initial states (made by JAX) and the same per-game schedules (B=16, 40
control steps of the bench workload: U(-8, 8) held 10 steps,
winning_score=4, the port's two-phase exact step against JAX's one-phase
one) through both ``_run_batch``es.
Scores are exact; damage agrees to f32 roundoff amplified over 40
free-running steps (5e-4); ``aggregate`` agrees."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import lax

from robogame_tpu.config import SimParams as JParams

import robogame_tpu_torch as rt
from _port_env import port_module  # noqa: F401  (autouse fixture)

# the parallel packages export a function of the module's name
jmc = importlib.import_module("robogame_tpu.parallel.monte_carlo")
tmc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")

B, N_STEPS, HOLD = 16, 40, 10


def _jax_policy(ps, states):
    k, u_base = ps
    u = lax.dynamic_index_in_dim(u_base, k // HOLD, keepdims=False)
    return (k + 1, u_base), u


def _torch_policy(ps, states):
    k, u_base = ps
    return (k + 1, u_base), u_base[k // HOLD]


def test_run_batch_matches_jax_from_common_states():
    # JAX's one-phase step: the same states as its two-phase one (JAX's
    # tests hold the two equal bitwise), without the second kernel call
    jp = JParams(dtype="float32", engine="pallas_exact", winning_score=4,
                 two_phase=False)
    tp = rt.SimParams(dtype="float32", engine="pallas_exact",
                      winning_score=4)
    js = jax.jit(jmc._initial_states, static_argnums=(0, 1))(
        jp, jmc.McParams(num_runs=B, randomize_x0=True))
    u_base = np.random.default_rng(0).uniform(
        -8, 8, (N_STEPS // HOLD, B, 4, 2)).astype(np.float32)
    jf, _, _ = jmc._run_batch(js, jp, N_STEPS, _jax_policy,
                              (jnp.asarray(0), jnp.asarray(u_base)))
    ts = rt.from_numpy(np.asarray(js.x), np.asarray(js.score),
                       np.asarray(js.damage), np.asarray(js.t),
                       seeds=range(1, B + 1), device="cpu")
    tf, (k, _) = tmc._run_batch(ts, tp, N_STEPS, _torch_policy,
                                (0, torch.from_numpy(u_base)), device="cpu")
    assert k == N_STEPS
    np.testing.assert_array_equal(tf.score.numpy(), np.asarray(jf.score))
    np.testing.assert_allclose(tf.damage.numpy(), np.asarray(jf.damage),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_array_equal(tf.t.numpy(), np.asarray(jf.t))
    assert float(np.asarray(jf.damage).sum()) > 0
    ja = jmc.aggregate(jmc.McResult(jf.score, jf.damage, jf.t))
    ta = rt.aggregate(rt.McResult(tf.score, tf.damage, tf.t))
    for key in ("games", "wins_a", "wins_b"):
        assert ja[key] == ta[key], key
    for key in ("mean_score_a", "mean_score_b", "mean_total_damage"):
        np.testing.assert_allclose(ta[key], ja[key], rtol=1e-4, atol=1e-6)


def test_monte_carlo_end_to_end_and_configuration_file(tmp_path):
    """The port's monte_carlo on the CPU: its own initial states, finite
    results of the right shapes, the zero-policy goal shot of
    tests/test_monte_carlo.py, and JAX's configuration.txt."""
    tp = rt.SimParams(engine="pallas_exact", winning_score=100)
    mc = rt.McParams(num_runs=4, T=2.0, x0_ball=(3.2, 0.0, 9.0, 0.0),
                     log_prefix=str(tmp_path / "t"))
    res = rt.monte_carlo(tp, mc, write_config=True, device="cpu")
    np.testing.assert_array_equal(res.scores.numpy(), [[1, 0]] * 4)
    np.testing.assert_allclose(res.t_final.numpy(), 2.0, rtol=1e-5)
    mcr = rt.McParams(num_runs=6, T=0.5, randomize_x0=True,
                      log_prefix=str(tmp_path / "r"))
    s0 = tmc._initial_states(tp, mcr, device="cpu")
    assert s0.x.shape == (6, 5, 4) and (s0.key[:, 0] == torch.arange(
        1, 7)).all()
    assert (s0.x[:, 4, :2].abs() <= torch.tensor([2.0, 1.0])).all()
    res = rt.monte_carlo(tp, mcr, device="cpu")
    assert res.damage.shape == (6, 4, 4)
    assert torch.isfinite(res.damage).all()
    jpar = JParams(engine="pallas_exact", winning_score=100)
    jmc.write_configuration(jpar, jmc.McParams(
        num_runs=4, T=2.0, x0_ball=(3.2, 0.0, 9.0, 0.0),
        log_prefix=str(tmp_path / "j")))
    assert (tmp_path / "t" / "configuration.txt").read_text() == \
        (tmp_path / "j" / "configuration.txt").read_text()
