"""The port's exact MIQP branch and bound against the JAX package's, on
tests/test_miqp.py's instance (one obstacle box dead on the straight
path, N=5, dt=0.3, f64 on both sides).

* ``solve_bb_exact``: the same status as JAX's, the objective within
  1e-3 (1 + f) of JAX's and of the port's ``solve_enumerate`` (all 4^5
  side assignments), fewer than 512 nodes, and the trajectory feasible
  for every l-inf keep-out (tests/test_miqp.py's checks).
* An infeasible start (knot 0 inside the box) is flagged, as in JAX.
* The solve-then-fix incumbent (``intercepting_with_obs_avoidance_bb``)
  is MIQP-feasible and within JAX's measured gap of the exact optimum.
"""

import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.control import miqp as jmiqp

import robogame_tpu_torch as rt
from robogame_tpu_torch.control import miqp
from robogame_tpu_torch.control.obstacles import (
    intercepting_with_obs_avoidance_bb)
from robogame_tpu_torch.models.lqsys import exact_ab
from _port_env import port_module  # noqa: F401  (autouse fixture)

P = rt.SimParams(dtype="float64", dt=0.3)
P0, V0 = np.array([-1.5, 0.0]), np.zeros(2)
PF, VF = np.array([1.5, 0.0]), np.zeros(2)
OBS = np.array([[0.0, 0.0]])
S = np.array([0.45])
MASK = np.array([True])
N = 5


def _linf_ok(U, tol):
    """Whether the knots of U (2N,) keep out of every l-inf box."""
    A, B = exact_ab(torch.tensor(P.dt, dtype=torch.float64), P.tau_player,
                    torch.float64)
    x = torch.cat([torch.from_numpy(P0), torch.from_numpy(V0)])
    ps = []
    for k in range(N):
        x = A @ x + B @ torch.from_numpy(U.reshape(N, 2)[k])
        ps.append(x[:2].numpy())
    d = np.abs(np.stack(ps)[None] - OBS[:, None]).max(-1)
    return bool(np.all(~MASK[:, None] | (d >= S[:, None] - tol)))


@pytest.fixture(scope="module")
def exact():
    return miqp.solve_bb_exact(P0, V0, PF, VF, OBS, S, MASK, P, N,
                               device="cpu")


def test_bb_against_jax_and_enumeration(exact):
    traj, info = exact
    _, jinfo = jmiqp.solve_bb_exact(P0, V0, PF, VF, OBS, S, MASK,
                                    JParams(dtype="float64", dt=0.3), N)
    assert bool(traj.success), info
    assert info["status"] == jinfo["status"] == "optimal"
    f = info["objective"]
    f_j = jinfo["objective"]
    assert abs(f - f_j) <= 1e-3 * (1 + f_j), (f, f_j)
    f_enum = miqp.solve_enumerate(P0, V0, PF, VF, OBS, S, MASK, P, N,
                                  device="cpu")
    assert np.isfinite(f_enum)
    assert abs(f - f_enum) <= 1e-3 * (1 + f_enum), (f, f_enum)
    assert info["nodes"] < 4 ** N / 2
    assert traj.u.dtype == torch.float64 and int(traj.length) == N
    U = traj.u.numpy()[:, :N].T.reshape(-1)
    assert _linf_ok(U, 5e-3)


def test_bb_infeasible_start():
    """Knot 0 inside the keep-out box: flagged, as JAX flags it."""
    start = np.array([0.1, 0.1])
    traj, info = miqp.solve_bb_exact(start, V0, PF, VF, OBS, S, MASK, P, N,
                                     device="cpu")
    _, jinfo = jmiqp.solve_bb_exact(start, V0, PF, VF, OBS, S, MASK,
                                    JParams(dtype="float64", dt=0.3), N)
    assert not bool(traj.success) and int(traj.length) == 1
    assert info["status"] == jinfo["status"] == "infeasible_x0"


def test_incumbent_optimality_gap(exact):
    f_exact = exact[1]["objective"]
    obs_pad = np.zeros((4, 2))
    obs_pad[0] = OBS[0]
    r_pad = np.zeros(4)
    r_pad[0] = S[0]
    m_pad = np.zeros(4, bool)
    m_pad[0] = True
    traj = intercepting_with_obs_avoidance_bb(P0, V0, PF, VF, obs_pad, r_pad,
                                              m_pad, P, N, device="cpu")
    assert bool(traj.success)
    U = traj.u.numpy()[:, :N].T.reshape(-1)
    assert _linf_ok(U, 1e-2), "incumbent must be MIQP-feasible"
    f_inc = float(U @ U)
    assert f_inc >= f_exact - 1e-2 * (1 + f_exact)
    assert f_inc <= 1.5 * f_exact + 1e-6, (f_inc, f_exact)
