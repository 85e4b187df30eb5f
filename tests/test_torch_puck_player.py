"""The port's puck-player MPC and the DMPC solve over given step sizes
against the JAX package's, on the same inputs made with numpy.

* ``dmpc.candidates`` is ``candidate_steps`` plus ``solve_candidates``,
  bitwise, on a warm state (route "plain"); ``solve_candidates`` is held
  against JAX's ``_solve_candidate`` through the puck player below.
* ``JointPuckPlayerMPC`` against JAX's ``compute_control`` over two calls
  (cold, then warm), in f64 and f32, with 0, 2 and 4 obstacles (padded to
  or trimmed to the 3 neighbour slots): u1 within 2e-3 + 1e-2 |u| (as
  tests/test_torch_dmpc.py holds the per-agent DMPC), the winner's step
  size and the valid flag equal, u2 zeros, and JAX's own pin u1[0] > 0.5
  on the first call (tests/test_utils.py).
"""

import numpy as np
import pytest
import torch

from robogame_tpu.config import MpcParams as JMpc
from robogame_tpu.config import SimParams as JParams
from robogame_tpu.control import puck_player_mpc as jpp

import robogame_tpu_torch as rt
from robogame_tpu_torch.control import dmpc as tdm
from robogame_tpu_torch.control import puck_player_mpc as tpp
from _port_env import port_module  # noqa: F401  (autouse fixture)

X_ATOL, X_RTOL = 2e-3, 1e-2
# tests/test_utils.py's controller
MPC = dict(N=10, t_grid=4, sqp_iters=2, qp_iters=80)
X_P1, X_P2 = np.array([-2.0, 0, 0, 0]), np.array([-2.0, -1, 0, 0])
X_PUCK, P_GOAL = np.array([1.0, 0, 0, 0]), np.array([5.0, 0.0])
OBSTACLES = np.array([[3.0, 2.0], [3.0, -2.0], [0.0, 1.2], [0.5, -1.5]])
# the second call's state: the puck and player 1 moved
X_P1_2, X_PUCK_2 = np.array([-1.7, 0.1, 2.0, 0.5]), np.array([1.2, 0.3, 0.5,
                                                              0.0])


def _instances(Bq, seed):
    rng = np.random.default_rng(seed)

    def pos(*shape):
        return np.stack([rng.uniform(-4.5, 4.5, shape),
                         rng.uniform(-2.2, 2.2, shape)], -1)

    x0 = np.concatenate([pos(Bq), rng.uniform(-2, 2, (Bq, 2))], -1)
    x_des = np.concatenate([pos(Bq), rng.uniform(-3, 3, (Bq, 2))], -1)
    return x0, x_des, pos(Bq, 3)


def test_candidates_is_candidate_steps_plus_solve():
    mpc = rt.MpcParams(N=8, t_grid=4, sqp_iters=2, qp_iters=60)
    params = rt.SimParams(dtype="float64")
    Bq = 3
    x0, x_des, obs = _instances(Bq, 5)
    rng = np.random.default_rng(6)
    st = tdm.DmpcState(
        U=torch.from_numpy(rng.uniform(-3, 3, (Bq, 2 * mpc.N))),
        valid=torch.tensor([True, False, True]),
        h=torch.tensor([0.02, 0.0, 0.1], dtype=torch.float64))
    t = [torch.from_numpy(a) for a in (x0, x_des, obs)]
    c = tdm.candidates(st, *t, params, mpc, route="plain")
    hs = tdm.candidate_steps(params.dt * mpc.minT_frac / mpc.N, 5.0 / mpc.N,
                             mpc.t_grid, mpc.t_local, st.h, st.valid,
                             torch.float64)
    U0 = torch.where(st.valid[:, None], st.U, 0.0)
    s = tdm.solve_candidates(hs, U0, *t, params, mpc, route="plain")
    assert c.margin is None and s.margin is None
    for a, b in zip(c[:4], s[:4]):
        assert torch.equal(a, b)
    assert bool(c.conv.any())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_obs", [0, 2, 4])
def test_puck_player_against_jax(dtype, n_obs):
    npd = np.dtype(dtype)
    jp = JParams(dtype=dtype)
    mpc = rt.MpcParams(**MPC)
    ctrl = tpp.JointPuckPlayerMPC(rt.SimParams(dtype=dtype), mpc,
                                  device="cpu")
    jstate = jpp.initial_state(JMpc(**MPC), jp.jdtype)
    obs = OBSTACLES[:n_obs].astype(npd)
    # JAX's own padding (1e3) or trimming to the 3 neighbour slots, done
    # here so that JAX compiles once a dtype; the port gets ``obs`` as is
    jobs = np.concatenate([obs, np.full((3, 2), 1e3, npd)])[:3]
    for call, (x_p1, x_puck) in enumerate(((X_P1, X_PUCK),
                                           (X_P1_2, X_PUCK_2))):
        args = [a.astype(npd) for a in (x_p1, X_P2, x_puck, P_GOAL)]
        jstate, ju1, ju2 = jpp.compute_control(jstate, *args, jobs, jp,
                                               JMpc(**MPC))
        ok, u1, u2 = ctrl.compute_control(*args, obs)
        assert ok and u1.dtype == npd
        np.testing.assert_array_equal(u2, np.zeros(2))
        np.testing.assert_allclose(u1, np.asarray(ju1), atol=X_ATOL,
                                   rtol=X_RTOL)
        st = ctrl.state.p1
        assert bool(st.valid) == bool(jstate.p1.valid)
        assert float(st.h) == float(jstate.p1.h)
        np.testing.assert_allclose(st.U.numpy(), np.asarray(jstate.p1.U),
                                   atol=X_ATOL, rtol=X_RTOL)
        # the first call drives toward the puck (at +x)
        assert call or u1[0] > 0.5
