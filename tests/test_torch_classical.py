"""The port's classical team and CBF-filtered matchup against the JAX
package's, per control step from common states.

A closed loop is chaotic, so nothing free-running is compared: the port's
plain exact step drives B=6 games for 10 steps (the matchup's randomized
puck starts, made by JAX), and at every step both sides get the same game
state and the same team states (the port's, carried across with
``team_state_to_numpy``) and run ``team_policy_batch`` for both teams and
``safe_control_batch`` on the same nominal controls.

Per step the plays, playback indices and lengths are equal, and controls
and installed trajectories agree within 2e-3 (plus 1e-3 relative), except
in games where one of the 5 candidate skills has its best two final-time
costs within NEAR_TIE: there f32 roundoff may pick another candidate.  The
number of such games is printed and bounded.  The CBF output agrees to
1e-4 where both sides' flags agree.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from robogame_tpu.agents import classical as jcl
from robogame_tpu.config import CbfParams as JCbf
from robogame_tpu.config import SimParams as JParams
from robogame_tpu.config import StrategyParams as JStrat
from robogame_tpu.control.cbf import safe_control_batch as j_safe_batch

import robogame_tpu_torch as rt
from robogame_tpu_torch.agents import classical as tcl
from robogame_tpu_torch.control import trajopt as ttraj
from _port_env import port_module  # noqa: F401  (autouse fixture)

jmc = importlib.import_module("robogame_tpu.parallel.monte_carlo")
tmc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")

JP = JParams(dtype="float32", engine="pallas_exact", winning_score=4)
TP = rt.SimParams(dtype="float32", engine="pallas_exact", winning_score=4)
NEAR_TIE = 1e-3
ATOL, RTOL = 2e-3, 1e-3


def _to_jax(ts):
    n = rt.team_state_to_numpy(ts)
    return jcl.TeamState(goalie=jcl.PlayerState(*map(jnp.asarray, n.goalie)),
                         player=jcl.PlayerState(*map(jnp.asarray, n.player)),
                         curr_play=jnp.asarray(n.curr_play))


def _near_tie_games(x, field):
    """(B,) games where a candidate skill's best two costs nearly tie."""
    B = x.shape[0]
    cands = tcl._team_candidates(x, field, TP, rt.StrategyParams())
    _, costs, _, _ = ttraj.candidate_costs(
        *(a.reshape(B * 5, 2) for a in cands[:4]), TP)
    c = np.sort(costs.numpy(), axis=0)
    return ((c[1] - c[0]) <= NEAR_TIE).reshape(B, 5).any(axis=1)


_j_initial_states = jax.jit(jmc._initial_states, static_argnums=(0, 1))


def _common_states(B):
    js = _j_initial_states(JP, jmc.McParams(
        num_runs=B, randomize_x0=True, x0_pos_range=(1.0, 0.5),
        x0_vel_range=2.0))
    return rt.from_numpy(np.asarray(js.x), np.asarray(js.score),
                         np.asarray(js.damage), np.asarray(js.t),
                         seeds=range(1, B + 1), device="cpu")


def test_team_policy_and_cbf_match_jax_per_step():
    B, steps = 6, 10
    s = _common_states(B)
    teams = {-1: rt.initial_team_state(B, device="cpu"),
             1: rt.initial_team_state(B, device="cpu")}
    n_tie = n_cmp = n_replan = 0
    for _ in range(steps):
        us = []
        for field in (-1, 1):
            ts = teams[field]
            jts, ju = jcl.team_policy_batch(
                _to_jax(ts), jnp.asarray(s.x.numpy()), field, JP, JStrat(),
                use_lanes=False)
            nts, u = rt.team_policy_batch(ts, s.x, field, TP,
                                          rt.StrategyParams())
            np.testing.assert_array_equal(nts.curr_play.numpy(),
                                          np.asarray(jts.curr_play))
            ok = ~_near_tie_games(s.x, field)
            n_tie += int((~ok).sum())
            n_cmp += B
            for name in ("goalie", "player"):
                a, b = getattr(nts, name), getattr(jts, name)
                np.testing.assert_array_equal(a.t_idx.numpy()[ok],
                                              np.asarray(b.t_idx)[ok])
                np.testing.assert_array_equal(a.length.numpy()[ok],
                                              np.asarray(b.length)[ok])
                np.testing.assert_allclose(a.u_traj.numpy()[ok],
                                           np.asarray(b.u_traj)[ok],
                                           atol=ATOL, rtol=RTOL)
                n_replan += int((a.t_idx.numpy() == 1).sum())
            np.testing.assert_allclose(u.numpy()[ok], np.asarray(ju)[ok],
                                       atol=ATOL, rtol=RTOL)
            teams[field] = nts
            us.append(u)
        u = torch.cat(us, dim=1)
        pos, vel = s.x[:, :4, 0:2], s.x[:, :4, 2:4]
        jr = j_safe_batch(*(jnp.asarray(a.numpy()) for a in (u, pos, vel)),
                          JP, JCbf(), use_lanes=False)
        tr = rt.safe_control_batch(u, pos, vel, TP, rt.CbfParams())
        agree = tr.converged.numpy() == np.asarray(jr.converged)
        assert agree.mean() >= 5 / 6
        np.testing.assert_allclose(tr.u.numpy()[agree],
                                   np.asarray(jr.u)[agree], atol=1e-4)
        s = rt.step_batch(s, tr.u, TP, device="cpu")
    print(f"near-tie games: {n_tie} of {n_cmp} team steps; "
          f"{n_replan} fresh installs")
    assert n_tie <= n_cmp // 4
    assert n_replan >= B          # the first step plans every game


def test_team_policy_one_game_equals_the_batch():
    B = 4
    s = _common_states(B)
    ts = rt.initial_team_state(B, device="cpu")
    bts, bu = rt.team_policy_batch(ts, s.x, 1, TP, rt.StrategyParams())
    for i in range(B):
        one = tcl._map(lambda a: a[i], ts)
        ots, ou = rt.team_policy(one, s.x[i], 1, TP, rt.StrategyParams())
        np.testing.assert_allclose(ou.numpy(), bu[i].numpy(), atol=1e-5)
        assert int(ots.player.length) == int(bts.player.length[i])


def test_classical_team_run_on_22_vector_matches_jax():
    """The reference API over a flat state vector: a fresh team on each
    side, one step from the reset state with the puck at (-1, 0) and from
    a second vector.  JAX's per-game policy plans on its own f32 T grid
    (see test_torch_trajopt_cbf), hence the per-game tolerance 6e-3."""
    vecs = [np.array([0, 0, -1.0, 0, 0, 0, -2.5, 1.25, 0, 0, -2.5, -1.25,
                      0, 0, 2.5, 1.25, 0, 0, 2.5, -1.25, 0, 0]),
            np.array([1, 0, 3.0, -1.0, 1.0, 0.5, -4.0, 0.5, 0.2, 0.0,
                      -1.0, -1.5, 0.0, 1.0, 2.0, 1.0, -1.0, 0.0, 4.0,
                      -2.0, 0.5, 0.5])]
    for field, team in ((-1, "A"), (1, "B")):
        jt = jcl.ClassicalTeam(JP, field, team)
        tt_ = rt.ClassicalTeam(TP, field, team, device="cpu")
        for vec in vecs:
            jg, jpl = jt.run(vec.astype(np.float32))
            tg, tpl = tt_.run(vec)
            assert tg.shape == tpl.shape == (2,)
            np.testing.assert_allclose(tg, np.asarray(jg), atol=6e-3)
            np.testing.assert_allclose(tpl, np.asarray(jpl), atol=6e-3)
        assert int(tt_.state.curr_play) == int(jt.state.curr_play)


def test_team_state_numpy_round_trip():
    B = 3
    j0 = jcl.initial_team_state(jnp.float32)
    jb = jcl.TeamState(
        goalie=jcl.PlayerState(*(np.broadcast_to(np.asarray(a), (B,) +
                                                 np.shape(a))
                                 for a in j0.goalie)),
        player=jcl.PlayerState(*(np.broadcast_to(np.asarray(a), (B,) +
                                                 np.shape(a))
                                 for a in j0.player)),
        curr_play=np.broadcast_to(np.asarray(j0.curr_play), (B,)))
    ts = rt.team_state_from_numpy(jb, device="cpu")
    init = rt.initial_team_state(B, device="cpu")
    for a, b in zip(_leaves(ts), _leaves(init)):
        assert torch.equal(a, b)
    s = _common_states(B)
    ts2, _ = rt.team_policy_batch(ts, s.x, -1, TP, rt.StrategyParams())
    back = rt.team_state_from_numpy(rt.team_state_to_numpy(ts2),
                                    device="cpu")
    for a, b in zip(_leaves(back), _leaves(ts2)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert ts2.goalie.t_idx.dtype == torch.int32


def _leaves(ts):
    return [*ts.goalie, *ts.player, ts.curr_play]


def test_matchup_runs_through_monte_carlo_and_keeps_its_carry():
    """classical_matchup, with and without the CBF filter, as a monte_carlo
    policy on the CPU: the TeamState carry goes through _run_batch exactly
    as the policy returns it, and the games step to finite states."""
    B, steps = 4, 6
    for cbf in (None, rt.CbfParams()):
        policy, ps = rt.classical_matchup(TP, B, cbf=cbf, device="cpu")
        seen = []

        def spy(carry, states, policy=policy):
            out = policy(carry, states)
            seen.append(out[0])
            return out

        s0 = _common_states(B)
        final, carry = tmc._run_batch(s0, TP, steps, spy, ps, device="cpu")
        assert len(seen) == steps and carry is seen[-1]
        assert isinstance(carry[0], rt.TeamState)
        assert carry[0].goalie.u_traj.shape == (B, 2, ttraj.MAX_TRAJ)
        assert bool(torch.isfinite(final.x).all())
        np.testing.assert_allclose(final.t.numpy(), steps * TP.dt,
                                   rtol=1e-5)
