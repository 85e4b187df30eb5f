"""The port's single-player planners against the JAX package's, in f64 on
the same numpy inputs: ``solve_box_ls``, the fixed-final-time planners
``intercepting_traj`` and ``min_time_bounce_kick_traj``, the bounce-pass
planner with ``simulate_bounce``, and the obstacle planners
``intercepting_with_obs_avoidance``, its side variant and
``min_time_traj_avoid_obs``.

Each comparison holds the port to JAX within the tolerance of the JAX
test that pins that planner (``tests/test_ops.py``, ``test_trajopt.py``,
``test_control.py``) with the same success flags, and the port's plan
passes that test's own checks.  Both sides run the same fixed-iteration
ADMM in f64, so they agree far inside those tolerances (about 1e-11 on
these inputs).  The horizons are the smallest that exercise the planners,
at most two JAX compiles each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import SimParams as JParams
from robogame_tpu.control import contact as jcontact
from robogame_tpu.control import obstacles as jobs
from robogame_tpu.control import trajopt as jtraj
from robogame_tpu.ops import qp as jqp

from robogame_tpu_torch.config import SimParams
from robogame_tpu_torch.control import contact as tcontact
from robogame_tpu_torch.control import obstacles as tobs
from robogame_tpu_torch.control import trajopt as ttraj
from robogame_tpu_torch.models.lqsys import condense, exact_ab
from robogame_tpu_torch.ops import qp as tqp
from _port_env import port_module  # noqa: F401  (autouse fixture)

JP, TP = JParams(dtype="float64"), SimParams(dtype="float64")
F64 = torch.float64


def _np(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _same_plan(a, b, atol):
    """JAX's trajectory a and the port's b: flags and lengths equal,
    controls within atol."""
    assert bool(a.success) == bool(b.success)
    assert int(a.length) == int(b.length)
    np.testing.assert_allclose(float(b.T), float(a.T), rtol=1e-12)
    np.testing.assert_allclose(_np(b.u), _np(a.u), rtol=0, atol=atol)


def _playback(x0, traj, n=None):
    """Positions and velocities after each step of the port's plan through
    the exact player model, (n, 4)."""
    A, B = exact_ab(TP.dt, TP.tau_player, F64)
    x = torch.as_tensor(x0, dtype=F64)
    xs = []
    for k in range(int(traj.length) if n is None else n):
        x = A @ x + B @ traj.u[:, k]
        xs.append(x.numpy())
    return np.stack(xs)


def test_solve_box_ls_matches_jax():
    """tests/test_ops.py:44 (to 1e-5 of [1, -1]), and a batch of three
    random 6 x 4 problems against JAX's one by one within 1e-9."""
    F = np.array([[2.0, 0.0], [0.0, 1.0]])
    b = np.array([4.0, -3.0])
    ref = jqp.solve_box_ls(jnp.asarray(F), jnp.asarray(b), -jnp.ones(2),
                           jnp.ones(2), iters=200)
    got = tqp.solve_box_ls(torch.from_numpy(F), torch.from_numpy(b),
                           -torch.ones(2, dtype=F64), torch.ones(2, dtype=F64),
                           iters=200)
    np.testing.assert_allclose(got.numpy(), [1.0, -1.0], atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    rng = np.random.default_rng(6)
    Fs, bs = rng.normal(size=(3, 6, 4)), rng.normal(size=(3, 6))
    lo, hi = -0.3 * np.ones(4), 0.4 * np.ones(4)
    got = tqp.solve_box_ls(torch.from_numpy(Fs), torch.from_numpy(bs),
                           torch.from_numpy(lo), torch.from_numpy(hi))
    for i in range(3):
        ref = jqp.solve_box_ls(jnp.asarray(Fs[i]), jnp.asarray(bs[i]),
                               jnp.asarray(lo), jnp.asarray(hi))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-9)


def test_intercepting_traj_matches_jax():
    """tests/test_trajopt.py::test_intercepting_traj_terminal_equality:
    the terminal state within 5e-2, the plans within 5e-2 of JAX's."""
    p0, v0 = np.array([-1.0, 0.5]), np.array([0.5, 0.0])
    pf, vf = np.array([0.5, -0.5]), np.array([2.0, 0.0])
    a = jtraj.intercepting_traj(*map(jnp.asarray, (p0, v0, pf, vf)), JP, 20)
    b = ttraj.intercepting_traj(p0, v0, pf, vf, TP, 20, device="cpu")
    assert bool(b.success)
    _same_plan(a, b, 5e-2)
    xT = _playback(np.concatenate([p0, v0]), b)[-1]
    assert np.abs(xT - np.concatenate([pf, vf])).max() < 5e-2


def test_min_time_bounce_kick_traj_matches_jax():
    """tests/test_trajopt.py::test_bounce_kick_final_velocity_...: the
    reset map at the kick point imparts the desired puck velocity within
    0.15, the plans within 0.15 of JAX's."""
    m1, m2 = TP.player_mass, TP.puck_mass
    p0, v0 = np.zeros(2), np.zeros(2)
    p_puck, v_puck, v_des = np.array([1.0, 0.5]), np.zeros(2), \
        np.array([2.0, 1.0])
    args = (p0, v0, p_puck, v_puck, v_des)
    a = jtraj.min_time_bounce_kick_traj(*map(jnp.asarray, args), JP)
    b = ttraj.min_time_bounce_kick_traj(*args, TP, device="cpu")
    assert bool(b.success)
    _same_plan(a, b, 0.15)
    xT = _playback(np.concatenate([p0, v0]), b)[-1]
    n = p_puck - xT[:2]
    c = 2 * m1 / (m1 + m2)
    v_after = v_puck - c * np.dot(v_puck - xT[2:], n) / np.dot(n, n) * n
    np.testing.assert_allclose(v_after, v_des, atol=0.15)


def test_bounce_pass_wall_and_flight_match_jax():
    """tests/test_control.py::test_bounce_pass_reaches_goal, both walls:
    the plans and flights within 1e-6 of JAX's, the port's flight on the
    wall and in the goal within 1e-6, its end velocity into the goal; a
    wall name other than "up" or "down" raises."""
    jp, tp = JParams(dtype="float64", tau_puck=1.0), \
        SimParams(dtype="float64", tau_puck=1.0)
    p_puck, p_goal = np.array([-2.0, 0.0]), np.array([5.0, 0.0])
    for wall in ("up", "down"):
        a = jcontact.bounce_pass_wall(jnp.asarray(p_puck),
                                      jnp.asarray(p_goal), wall, jp)
        b = tcontact.bounce_pass_wall(p_puck, p_goal, wall, tp,
                                      device="cpu")
        assert bool(a.success) and bool(b.success)
        np.testing.assert_allclose(b.v0.numpy(), np.asarray(a.v0), atol=1e-6)
        np.testing.assert_allclose(b.h.numpy(), np.asarray(a.h), atol=1e-6)
        fa = jcontact.simulate_bounce(jnp.asarray(p_puck), a.v0, a.h[0],
                                      a.h[1], jp, wall)
        fb = tcontact.simulate_bounce(torch.from_numpy(p_puck), b.v0, b.h[0],
                                      b.h[1], tp, wall)
        for x, y in zip(fa, fb):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6)
        p_c, p_end, v_end = (t.numpy() for t in fb)
        sgn = 1.0 if wall == "up" else -1.0
        np.testing.assert_allclose(p_c[1], sgn * (tp.arena_y / 2 -
                                                  tp.puck_radius), atol=1e-6)
        np.testing.assert_allclose(p_end, p_goal, atol=1e-6)
        assert v_end[0] >= 0.1 and sgn * v_end[1] <= -0.1
    with pytest.raises(ValueError):
        tcontact.bounce_pass_wall(np.zeros(2), np.zeros(2), "left", tp,
                                  device="cpu")


def _obstacle(p, jx=True):
    if jx:
        return jobs._obs_arrays([np.array(p)], None, JP, jnp.float64,
                                include_puck=False)
    return tobs._obs_arrays([np.array(p)], None, TP, F64,
                            include_puck=False, device="cpu")


@pytest.mark.parametrize("n,obs_p,p0,pf", [
    (20, [4.0, 2.0], [-1.0, 0.0], [1.0, 0.0]),     # inactive: the optimum
    (40, [-0.4, 0.02], [-1.5, 0.0], [1.5, 0.0]),   # on the path: a detour
])
def test_intercepting_with_obs_avoidance_matches_jax(n, obs_p, p0, pf):
    """tests/test_control.py: the plans within 2e-2 of JAX's; with the
    obstacle far away the closed-form optimum of the 10-terminal /
    1-effort cost within 2e-2, on the path a detour that keeps clear
    (2 r - 0.06) and makes progress."""
    p0, pf, z = np.array(p0), np.array(pf), np.zeros(2)
    a = jobs.intercepting_with_obs_avoidance(
        *map(jnp.asarray, (p0, z, pf, z)), *_obstacle(obs_p), JP, n)
    b = tobs.intercepting_with_obs_avoidance(
        p0, z, pf, z, *_obstacle(obs_p, False), TP, n, device="cpu")
    assert bool(b.success)
    _same_plan(a, b, 2e-2)
    xs = _playback(np.concatenate([p0, z]), b, n)
    if n == 20:
        A, B = exact_ab(TP.dt, TP.tau_player, F64)
        phi, gam = (t.numpy() for t in condense(A, B, n))
        gN, phiN = gam[4 * (n - 1):], phi[4 * (n - 1):]
        H = np.eye(2 * n) + 10 * gN.T @ gN
        U_star = np.linalg.solve(H, -10 * gN.T @ (
            phiN @ np.concatenate([p0, z]) - np.concatenate([pf, z])))
        np.testing.assert_allclose(b.u[:, :n].T.reshape(-1).numpy(), U_star,
                                   atol=2e-2)
    else:
        dmin = np.linalg.norm(xs[:, 0:2] - np.array(obs_p), axis=1).min()
        assert dmin >= 2 * TP.player_radius - 0.06
        assert xs[-1, 0] > p0[0] + 0.5


def test_intercepting_bb_variant_matches_jax():
    """tests/test_control.py::test_intercepting_bb_variant at 20 steps
    (the target 3 m away, where 40 steps took it 6 m): the plans within
    0.05 of JAX's, one axis clear of the obstacle at every knot
    (2 r - 0.06), the terminal state within 0.05."""
    p0, pf, z = np.array([-1.5, 0.0]), np.array([1.5, 0.0]), np.zeros(2)
    obs_p = np.array([0.0, 0.05])
    a = jobs.intercepting_with_obs_avoidance_bb(
        *map(jnp.asarray, (p0, z, pf, z)), *_obstacle(obs_p), JP, 20)
    b = tobs.intercepting_with_obs_avoidance_bb(
        p0, z, pf, z, *_obstacle(obs_p, False), TP, 20, device="cpu")
    assert bool(b.success)
    _same_plan(a, b, 0.05)
    xs = _playback(np.concatenate([p0, z]), b)
    dmin = np.abs(xs[:, 0:2] - obs_p).max(axis=1).min()
    assert dmin >= 2 * TP.player_radius - 0.06
    np.testing.assert_allclose(xs[-1], np.concatenate([pf, z]), atol=0.05)


def test_min_time_traj_avoid_obs_matches_jax():
    """tests/test_control.py::test_min_time_traj_avoid_obs: success with
    20 steps, the plans within 2e-2 of JAX's."""
    p0, v0 = np.array([-2.0, 0.0]), np.zeros(2)
    pf, vf = np.array([2.0, 0.0]), np.array([2.0, 0.0])
    a = jobs.min_time_traj_avoid_obs(*map(jnp.asarray, (p0, v0, pf, vf)),
                                     *_obstacle([0.0, 0.0]), JP)
    b = tobs.min_time_traj_avoid_obs(p0, v0, pf, vf,
                                     *_obstacle([0.0, 0.0], False), TP,
                                     device="cpu")
    assert bool(b.success) and int(b.length) == 20
    _same_plan(a, b, 2e-2)
