"""The port's ``ClassicalPlayer`` against the JAX package's: each of the
seven skills from three fixed game states (tests/test_agents.py:26-60),
the open-loop playback, and the reference's bank shot through the port's
``GameSim`` (tests/test_bounce_e2e.py), in f64 on the CPU; and, in the
``timed_kick`` case, that skill in f32 on both sides from one state (the
drivers' dtype).

The fixed-final-time, bounce and obstacle skills plan in f64 on both sides
and are held within 1e-6.  The min-time skills (``simple_kick``,
``defend_kick``, ``defend``) plan through ``min_time_traj``, which the
port solves on K2's plain version in f32 and JAX in f64: they are held to
the same final time and length, and controls within 2e-3 + 1e-3 |u|
(tests/test_torch_trajopt_cbf.py's tolerance; the controls reach the
input limit, 10).  No best two final-time costs of these states lie
within 1e-3 of each other, where f32 roundoff could rightly pick another
final time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu import SimStateView as JView
from robogame_tpu.agents.classical import ClassicalPlayer as JPlayer
from robogame_tpu.config import SimParams as JParams

import robogame_tpu_torch as rt
from robogame_tpu_torch.control import trajopt as ttraj

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield


def _vector(puck, players):
    """A 22-vector [scores, puck, A1, A2, B1, B2]."""
    return np.concatenate([[0.0, 0.0], puck, *players])


STATES = [
    _vector([1.0, 0.5, 0.0, 0.0], [[-2.5, 1.25, 0, 0], [-2.5, -1.25, 0, 0],
                                   [2.5, 1.25, 0, 0], [2.5, -1.25, 0, 0]]),
    _vector([-1.5, -0.8, 0.5, 0.2], [[-3.0, 0.5, 0.4, -0.2],
                                     [-1.0, -1.5, 1.0, 0.5],
                                     [1.5, 0.8, -0.5, 0.0],
                                     [0.5, -1.0, 0.0, 0.3]]),
    _vector([2.0, 1.0, -1.0, 0.0], [[-2.0, 0.0, 0.0, 0.0],
                                    [0.5, 1.5, -0.5, -0.5],
                                    [3.0, 0.5, 0.0, 0.0],
                                    [1.0, -0.5, 0.2, 0.0]]),
]
# (field, team, player_id) of the player planning in each state
WHO = [(-1, "A", 2), (-1, "A", 1), (1, "B", 2)]

F64_ATOL = 1e-6
U_ATOL, U_RTOL = 2e-3, 1e-3
SKILLS = {
    "timed_kick": (lambda pl, v: pl.timed_kick(v, 4.0, 1.0), False),
    "timed_kick_avoiding_obs": (
        lambda pl, v: pl.timed_kick_avoiding_obs(v, 4.0, 1.0), False),
    "simple_kick": (lambda pl, v: pl.simple_kick(v, 4.0), True),
    "simple_kick_avoiding_obs": (
        lambda pl, v: pl.simple_kick_avoiding_obs(v, 4.0), False),
    "bounce_kick": (lambda pl, v: pl.bounce_kick(v, "up"), False),
    "defend_kick": (lambda pl, v: pl.defend_kick(v, 4.0), True),
    "defend": (lambda pl, v: pl.defend(v), True),
}


@pytest.mark.parametrize("skill", list(SKILLS))
def test_skill_matches_jax(skill):
    """The skill's flag, its installed trajectory and five controls of
    playback with their completed shares, from each of the three states
    (bounce_kick with tau_puck=1, the reference's bank-shot setting)."""
    plan, min_time = SKILLS[skill]
    kw = dict(tau_puck=1.0) if skill == "bounce_kick" else {}
    jp, tp = JParams(dtype="float64", **kw), rt.SimParams(dtype="float64",
                                                          **kw)
    planned = 0
    for vec, (field, team, pid) in zip(STATES, WHO):
        a = JPlayer(jp, field, team, pid)
        b = rt.ClassicalPlayer(tp, field, team, pid, device="cpu")
        ok_a, ok_b = plan(a, JView(jnp.asarray(vec))), plan(
            b, rt.SimStateView(vec))
        assert ok_a == ok_b
        planned += ok_b
        assert int(a.state.length) == int(b.state.length)
        ua, ub = np.asarray(a.state.u_traj), b.state.u_traj.numpy()
        assert b.state.u_traj.dtype == torch.float64
        if min_time:
            np.testing.assert_allclose(ub, ua, rtol=U_RTOL, atol=U_ATOL)
        else:
            np.testing.assert_allclose(ub, ua, rtol=0, atol=F64_ATOL)
        for _ in range(5):
            (ca, pa), (cb, pb) = a.get_control(), b.get_control()
            np.testing.assert_allclose(cb, ca, rtol=U_RTOL, atol=U_ATOL)
            assert pa == pytest.approx(pb)
            assert a.is_idle() == b.is_idle()
    assert planned >= 2, f"{skill} planned in {planned} of 3 states"
    if skill == "timed_kick":
        _timed_kick_f32_matches_jax()


def _timed_kick_f32_matches_jax():
    """``timed_kick`` in f32 (the dtype the example drivers run) on both
    sides from the second state: the flag, the length, and the installed
    controls within the min-time skills' 2e-3 + 1e-2 |u| (an f32 probe of
    20 random states read at most 8.3e-4)."""
    jp, tp = JParams(dtype="float32"), rt.SimParams(dtype="float32")
    (field, team, pid), vec32 = WHO[1], STATES[1].astype(np.float32)
    a = JPlayer(jp, field, team, pid)
    b = rt.ClassicalPlayer(tp, field, team, pid, device="cpu")
    assert a.timed_kick(JView(jnp.asarray(vec32)), 4.0, 1.0)
    assert b.timed_kick(rt.SimStateView(vec32), 4.0, 1.0)
    assert int(a.state.length) == int(b.state.length)
    assert b.state.u_traj.dtype == torch.float32
    np.testing.assert_allclose(b.state.u_traj.numpy(),
                               np.asarray(a.state.u_traj), rtol=1e-2,
                               atol=2e-3)


def test_simple_kick_plays_back_then_idles():
    """tests/test_agents.py:26 and :41 on the port: a kick plans, plays
    back within the input limit and goes idle after its length; defend's
    goals are the reference's."""
    tp = rt.SimParams(dtype="float64")
    view = rt.SimStateView(rt.initial_state(tp, x0_puck=[1.0, 0.5, 0.0, 0.0],
                                            device="cpu"))
    player = rt.ClassicalPlayer(tp, -1, "A", 2, device="cpu")
    assert player.simple_kick(view, 4.0) and not player.is_idle()
    u0, pct = player.get_control()
    assert np.all(np.abs(u0) <= tp.input_limit + 1e-6) and pct < 1.0
    for _ in range(int(player.state.length) + 2):
        player.get_control()
    assert player.is_idle()
    assert player.idle() and player.is_idle()
    defender = rt.ClassicalPlayer(tp, -1, "A", 1, device="cpu")
    assert defender.defend(rt.SimStateView(rt.initial_state(
        tp, x0_puck=[2.0, 1.0, 0.0, 0.0], device="cpu")))
    assert np.allclose(defender.get_home_goal_pos(), [-5.0, 0.0])
    assert np.allclose(defender.get_adversary_goal_pos(), [5.0, 0.0])
    assert ttraj.MAX_TRAJ == player.state.u_traj.shape[1]


@pytest.mark.parametrize("wall", ["up", "down"])
def test_bank_shot_scores_through_gamesim(wall):
    """tests/test_bounce_e2e.py on the port: the bank shot planned by
    ``bounce_kick`` and played back through ``GameSim`` (the sweep engine,
    f64, tau_puck=1, winning_score=1, the puck at (-1, 0)) scores within
    120 steps, and the puck reaches |y| > 1.5 on the chosen side."""
    params = rt.SimParams(dt=0.05, winning_score=1, tau_puck=1.0,
                          engine="sweep", dtype="float64")
    sim = rt.GameSim(params, device="cpu")
    vec = sim.reset(dt=0.05, winning_score=1, tau_puck=1.0,
                    x0_ball=[-1.0, 0.0, 0.0, 0.0])
    player = rt.ClassicalPlayer(params, -1, "A", 2, device="cpu")
    assert player.bounce_kick(rt.SimStateView(vec), wall)
    z = np.zeros(2)
    puck_ys = []
    for _ in range(120):
        u, _ = player.get_control()
        vec = sim.run(z, u, z, z)
        puck_ys.append(float(vec[3]))
        if vec[0] >= 1:
            break
    assert vec[0] >= 1, f"no goal within 6 s (wall={wall})"
    sgn = 1.0 if wall == "up" else -1.0
    assert max(sgn * y for y in puck_ys) > 1.5, "puck never neared the wall"
