"""The golden kick-goal schedule through the port's exact step (the
plain PyTorch version of K1 on CPU tensors): its scores equal the JAX
package's ``step_pallas_batch`` at every control step (the JAX exact step
is itself pinned to the event engine and the compiled C++ reference)."""

import json
import os

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

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_golden_kick_goal_scores_match_jax():
    name = "kick_goal_10s"
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        meta = json.load(f)
    sched = np.loadtxt(os.path.join(GOLDEN, f"{name}.sched.txt"))
    sched = sched.reshape(-1, 1, 4, 2).astype(np.float32)
    jp = JParams(dt=meta["dt"], winning_score=100, dtype="float32",
                 engine="pallas_exact")
    tp = rt.SimParams(dt=meta["dt"], winning_score=100, dtype="float32",
                      engine="pallas_exact")
    sj = jax.jit(jax.vmap(lambda k: j_initial_state(jp, x0_puck=meta["x0"],
                                                    seed=k)))(
        jax.vmap(jax.random.PRNGKey)(jnp.zeros(1, jnp.uint32)))
    st = rt.initial_state(tp, x0_puck=meta["x0"], device="cpu")
    for k in range(meta["n_steps"]):
        sj = step_pallas_batch(sj, jnp.asarray(sched[k]), jp)
        st = rt.step_batch(st, torch.from_numpy(sched[k]), tp, device="cpu")
        np.testing.assert_array_equal(st.score.numpy(), np.asarray(sj.score))
    assert np.isfinite(st.x.numpy()).all()
