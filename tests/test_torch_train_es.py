"""The port's ES trainer (``robogame_tpu_torch.examples.train_es``) against
the JAX example (examples/train_es.py), on the CPU.

* ``policy_apply`` on seeded parameters in JAX's flat layout, carried
  across by ``theta_from_numpy``, equals JAX's ``vmap(policy_apply)``
  within 1e-6 of the input limit (the commands are limit x tanh, whose
  last ulps differ between the two tanh implementations);
* ``evaluate`` on the sweep engine, from JAX's own puck starts
  (``jax.random.split`` of the key, as ``make_eval`` draws them), equals
  JAX's ``make_eval(params, 5, 8)``: goals equal, rewards within 1e-5
  (f32 sums of 5 steps of roundoff-level state differences);
* ``evaluate`` on K6 (``engine="pallas"``, its plain version here) equals
  the sweep engine on the same starts within 1e-5 (no grinding in 5
  steps);
* ``es_update`` equals JAX's update written in numpy, with the
  population's std (ddof 0);
* ``main`` runs two generations on both engines and prints JAX's lines.

Two JAX jit compiles: ``policy_apply`` and ``make_eval`` with its starts.
"""

import importlib
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams

from robogame_tpu_torch.config import SimParams
from robogame_tpu_torch.examples import train_es as es
from _port_env import port_module  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POP, STEPS = 8, 5
P = es.n_params()


@pytest.fixture(scope="module")
def jes():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        return importlib.import_module("train_es")
    finally:
        sys.path.pop(0)


def _thetas(seed=0):
    return np.random.default_rng(seed).normal(0, 0.3, (POP, P)).astype(
        np.float32)


def test_layout_and_policy_apply_match_jax(jes):
    assert P == jes.n_params() == 354
    theta = _thetas(1)
    obs = np.random.default_rng(2).normal(0, 2.0, (POP, 8)).astype(
        np.float32)
    apply_j = jax.jit(jax.vmap(jes.policy_apply, in_axes=(0, 0, None)))
    th = es.theta_from_numpy(theta, device="cpu")
    # within 1e-6 of the input limit: tanh's last ulps, scaled by it
    for limit in (1.0, 10.0):
        want = apply_j(jnp.asarray(theta), jnp.asarray(obs), limit)
        got = es.policy_apply(th, torch.as_tensor(obs), limit)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6 * limit
    # a flat vector repeated over the candidates
    tiled = es.theta_from_numpy(theta[3], POP, device="cpu")
    assert tiled.shape == (POP, P) and torch.equal(tiled[5], tiled[0])
    assert torch.equal(tiled[0], torch.as_tensor(theta[3]))
    with pytest.raises(ValueError):
        es.theta_from_numpy(theta[:, :-1], device="cpu")


def test_evaluate_on_the_sweep_engine_matches_jax(jes):
    jp = JParams(dt=0.05, winning_score=100, engine="sweep",
                 dtype="float32")
    evaluate_j = jes.make_eval(jp, STEPS, POP)

    @jax.jit
    def run(thetas, key):
        # make_eval's puck starts, drawn as it draws them
        keys = jax.random.split(key, POP)
        k0 = jax.vmap(lambda k: jax.random.uniform(
            k, (2,), jnp.float32, -1.0, 1.0))(keys)
        x0 = jnp.concatenate([k0 * jnp.asarray([2.0, 1.5]),
                              jnp.zeros((POP, 2), jnp.float32)], axis=1)
        return evaluate_j(thetas, key), x0

    theta = _thetas(4)
    (r_j, g_j), x0 = run(jnp.asarray(theta), jax.random.PRNGKey(7))
    tp = SimParams(dt=0.05, winning_score=100, engine="sweep",
                   dtype="float32")
    r, g = es.make_eval(tp, STEPS, POP, "cpu")(
        es.theta_from_numpy(theta, device="cpu"),
        x0_puck=torch.tensor(np.asarray(x0)))
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_j))
    assert np.abs(r.numpy() - np.asarray(r_j)).max() <= 1e-5
    assert np.ptp(np.asarray(r_j)) > 1e-2      # the candidates differ

    # K6 (its plain version on the CPU) on the same starts
    r6, g6 = es.make_eval(tp.replace(engine="pallas"), STEPS, POP, "cpu")(
        es.theta_from_numpy(theta, device="cpu"),
        x0_puck=torch.tensor(np.asarray(x0)))
    assert torch.equal(g6, g) and (r6 - r).abs().max() <= 1e-5


def test_es_update_is_jax_formula_with_ddof_0():
    rng = np.random.default_rng(9)
    theta = rng.normal(0, 0.1, P).astype(np.float32)
    half = rng.normal(size=(POP // 2, P)).astype(np.float32)
    eps = np.concatenate([half, -half])
    rewards = rng.normal(-2.0, 1.5, POP).astype(np.float32)
    sigma, lr = 0.05, 0.03
    r = (rewards - rewards.mean()) / (rewards.std() + 1e-8)
    want = theta + lr * (r[:, None] * eps).mean(0) / sigma
    got = es.es_update(torch.as_tensor(theta), torch.as_tensor(eps),
                       torch.as_tensor(rewards), sigma, lr).numpy()
    assert np.abs(got - want).max() <= 1e-6
    r1 = (rewards - rewards.mean()) / (rewards.std(ddof=1) + 1e-8)
    ddof1 = theta + lr * (r1[:, None] * eps).mean(0) / sigma
    assert np.abs(got - ddof1).max() > 1e-4     # the std is pinned


@pytest.mark.parametrize("engine", ["sweep", "pallas"])
def test_main_prints_the_jax_lines(engine, capsys):
    assert es.main(["--cpu", "--gens", "2", "--pop", str(POP), "--steps",
                    str(STEPS), "--engine", engine]) == 0
    lines = capsys.readouterr().out.splitlines()
    num = r"-?\d+\.\d{3}"
    assert len(lines) == 3
    for g, line in enumerate(lines[:2]):
        assert re.fullmatch(rf"gen +{g}  reward +{num} \(best +{num}\)  "
                            rf"goals/ep \d+\.\d{{3}}  \[\d+s\]", line), line
    assert re.fullmatch(rf"trained policy: mean reward {num}, "
                        rf"goals/episode \d+\.\d{{3}} over {POP} games",
                        lines[2]), lines[2]
    with pytest.raises(SystemExit):
        es.main(["--cpu", "--pop", "7"])
