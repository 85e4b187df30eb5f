"""The port's DMPC team and closed-loop policy against the JAX package's,
per control step from common states (f32 on both sides).

A closed loop is chaotic, so nothing free-running is compared: the port's
plain exact step drives the games, and at every step both sides get the
same game state and the same warm DMPC states (JAX's, carried across with
``dmpc_state_from_numpy``).

* The team's inputs: targets, obstacle sets and plays equal JAX's.
* ``team_step_batch(route="plain")`` against JAX's ``team_step_batch``
  (its XLA route on the CPU) at N=8 with 3 SQP iterations of 80 ADMM
  iterations, B=4 games x 5 steps, both teams; and the fused route (K3's plain version) against
  JAX's fused route (interpret mode) at N=4 over 2 steps.  Controls within
  2e-3 + 1e-2 |u| and equal warm states (h, valid; U to the same
  tolerance) per agent, except where the agent's best candidate cost lies
  within NEAR_TIE of another step size's on the port's side (f32 roundoff
  may pick the other candidate); those are counted and bounded.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.agents import dmpc_team as jteam
from robogame_tpu.config import MpcParams as JMpc
from robogame_tpu.config import SimParams as JParams
from robogame_tpu.config import StrategyParams as JStrat
from robogame_tpu.control import dmpc as jdm

import robogame_tpu_torch as rt
from robogame_tpu_torch.agents import dmpc_team as tteam
from robogame_tpu_torch.control import dmpc as tdm

torch.set_num_threads(1)

tmc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")

JP = JParams(dtype="float32", engine="pallas_exact", winning_score=4)
TP = rt.SimParams(dtype="float32", engine="pallas_exact", winning_score=4)
NEAR_TIE = 1e-3
ATOL, RTOL = 2e-3, 1e-2


def _common_states(B, seed=0):
    """The matchups' randomized puck starts (the port's ``_initial_states``),
    players moved to random spots so that the obstacle sets vary."""
    s = tmc._initial_states(TP, rt.McParams(
        num_runs=B, randomize_x0=True, x0_pos_range=(1.0, 0.5),
        x0_vel_range=2.0), device="cpu")
    x = s.x.numpy().copy()
    rng = np.random.default_rng(seed)
    x[:, :4, 0] = rng.uniform(-4.5, 4.5, (B, 4))
    x[:, :4, 1] = rng.uniform(-2.2, 2.2, (B, 4))
    x[:, :4, 2:] = rng.normal(size=(B, 4, 2))
    return s._replace(x=torch.from_numpy(x))


def _jax_team_state(ts):
    n = rt.dmpc_state_to_numpy(ts)
    return jteam.DmpcTeamState(
        attacker=jdm.DmpcState(*map(jnp.asarray, n.attacker)),
        defender=jdm.DmpcState(*map(jnp.asarray, n.defender)))


def _near_ties(ts, x, field, mpc, route):
    """(B, 2) agents whose best candidate cost lies within NEAR_TIE of a
    candidate with another step size (a warm grid may hold one step size
    twice; those copies tie exactly on both sides)."""
    x0s, tgts, obss = tteam.team_inputs(x, field, TP, rt.StrategyParams())
    c = tdm.candidates(tteam._flat_states(ts), x0s.flatten(0, 1),
                       tgts.flatten(0, 1), obss.flatten(0, 1), TP, mpc, route)
    return (tdm.runner_up_gap(c) <= NEAR_TIE).numpy().reshape(-1, 2)


def _hold(tts, tu, jts, ju, ok):
    """Controls and warm states of the agents ``ok`` (B, 2)."""
    np.testing.assert_allclose(tu.numpy()[ok], np.asarray(ju)[ok],
                               atol=ATOL, rtol=RTOL)
    for i, name in enumerate(("attacker", "defender")):
        a, b = getattr(tts, name), getattr(jts, name)
        k = ok[:, i]
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
        np.testing.assert_array_equal(a.h.numpy()[k], np.asarray(b.h)[k])
        np.testing.assert_allclose(a.U.numpy()[k], np.asarray(b.U)[k],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("field", [-1, 1])
def test_team_inputs_and_play_match_jax(field):
    s = _common_states(16, seed=field + 2)
    x = s.x.clone()
    x[:4, 4, 0] = torch.tensor([4.9, -4.9, 0.0, 3.0])   # the puck's halves
    x[:4, 4, 2] = torch.tensor([3.0, -3.0, 0.0, 2.0])
    strat = rt.StrategyParams()
    jx = jnp.asarray(x.numpy())
    x0s, tgts, obss = tteam.team_inputs(x, field, TP, strat)
    rows = (0, 1, 2, 3) if field < 0 else (2, 3, 0, 1)
    np.testing.assert_array_equal(x0s.numpy(), x.numpy()[:, list(rows[:2])])
    for play in (0, 1):
        for role, i in ((tteam.ATTACKER, 0), (tteam.DEFENDER, 1)):
            ref = jax.jit(jax.vmap(lambda p: jteam.player_target(
                jnp.asarray(play), role, p, field, JP, JStrat())))(
                    jx[:, 4, :2])
            got = tteam.player_target(torch.full((16,), play), role,
                                      x[:, 4, :2], field, TP, strat)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-6)
            if play == 0:
                np.testing.assert_array_equal(tgts[:, i].numpy(),
                                              got.numpy())
    others = [[rows[1], rows[2], rows[3]], [rows[0], rows[2], rows[3]]]
    for i in (0, 1):
        np.testing.assert_array_equal(obss[:, i].numpy(),
                                      x.numpy()[:, others[i], 0:2])
    # the reference constants never defend; halved thresholds do
    for st, jst in ((strat, JStrat()),
                    (strat.replace(d_goalie_defense=5.2, d_goalie_offense=7.0),
                     JStrat(d_goalie_defense=5.2, d_goalie_offense=7.0))):
        ref = jax.jit(jax.vmap(lambda p: jteam.select_play(
            p, field, JP, jst)))(jx[:, 4])
        got = tteam.select_play(x[:, 4], field, TP, st)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not bool(tteam.select_play(x[:, 4], field, TP, strat).any())


def test_team_step_batch_plain_matches_jax_per_step():
    B, steps = 4, 5
    short = dict(N=8, sqp_iters=3, qp_iters=80)
    mpc, jm = rt.MpcParams(**short), JMpc(**short)
    s = _common_states(B)
    teams = {f: rt.DmpcTeamState(*(tdm.initial_dmpc_state(
        mpc, device="cpu", batch=(B,)) for _ in range(2))) for f in (-1, 1)}
    n_tie = 0
    for _ in range(steps):
        us = []
        for field in (-1, 1):
            ts = teams[field]
            jts, ju = jteam.team_step_batch(
                _jax_team_state(ts), jnp.asarray(s.x.numpy()), field, JP, jm,
                JStrat())
            tts, tu = tteam.team_step_batch(ts, s.x, field, TP, mpc,
                                            rt.StrategyParams(), "plain")
            ok = ~_near_ties(ts, s.x, field, mpc, "plain")
            n_tie += int((~ok).sum())
            _hold(tts, tu, jts, ju, ok)
            teams[field] = rt.dmpc_state_from_numpy(jts, device="cpu")
            us.append(tu)
        s = rt.step_batch(s, torch.cat(us, dim=1), TP, device="cpu")
    print(f"near-ties: {n_tie} of {2 * 2 * B * steps} agent steps")
    assert n_tie <= B * steps // 4
    assert bool(teams[1].attacker.valid.all())


@pytest.fixture(scope="module")
def fused_ref():
    """Two steps of both teams through JAX's fused route (interpret-mode
    K3, the one interpret-mode compile of this file) at N=4, from common
    states: [(x, field, JAX team state in, JAX team state out, u)]."""
    mpc = rt.MpcParams(N=4)
    jm = JMpc(N=4)
    B = 4
    s = _common_states(B, seed=5)
    jts = {f: _jax_team_state(rt.DmpcTeamState(*(tdm.initial_dmpc_state(
        mpc, device="cpu", batch=(B,)) for _ in range(2)))) for f in (-1, 1)}
    out = []
    for _ in range(2):
        us = []
        for field in (-1, 1):
            x0s, tgts, obss = tteam.team_inputs(s.x, field, TP,
                                                rt.StrategyParams())
            ts = jts[field]
            flat = jax.tree.map(lambda a, d: jnp.stack([a, d], 1).reshape(
                (2 * B,) + a.shape[1:]), ts.attacker, ts.defender)
            new, u = jdm.compute_control_batch(
                flat, *(jnp.asarray(a.flatten(0, 1).numpy())
                        for a in (x0s, tgts, obss)), JP, jm,
                use_lanes="fused")
            unflat = [np.asarray(a).reshape((B, 2) + a.shape[1:])
                      for a in new]
            jts[field] = jteam.DmpcTeamState(
                attacker=jdm.DmpcState(*(jnp.asarray(a[:, 0]) for a in unflat)),
                defender=jdm.DmpcState(*(jnp.asarray(a[:, 1]) for a in unflat)))
            u = np.array(u).reshape(B, 2, 2)
            out.append((s.x.clone(), field, ts, jts[field], u))
            us.append(torch.from_numpy(u))
        s = rt.step_batch(s, torch.cat(us, dim=1), TP, device="cpu")
    return mpc, out


def test_fused_policy_matches_jax_fused_route(fused_ref):
    """The fused route: K3's plain version against JAX's interpret-mode
    kernel, cold then warm (local candidate grid, U0 != 0)."""
    mpc, out = fused_ref
    n_tie = 0
    for x, field, jin, jout, ju in out:
        ts = rt.dmpc_state_from_numpy(jin, device="cpu")
        tts, tu = tteam.team_step_batch(ts, x, field, TP, mpc,
                                        rt.StrategyParams())
        ok = ~_near_ties(ts, x, field, mpc, "fused")
        n_tie += int((~ok).sum())
        _hold(tts, tu, jout, ju, ok)
    print(f"near-ties: {n_tie} of {8 * len(out)} agent steps")
    assert n_tie <= 8 and bool(np.asarray(out[-1][3].attacker.valid).any())


def test_dmpc_state_numpy_round_trip():
    B = 3
    mpc = rt.MpcParams()
    j0 = jteam.initial_team_state(JMpc())
    jb = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a), (B,) +
                                                np.shape(a)), j0)
    ts = rt.dmpc_state_from_numpy(jb, device="cpu")
    init = tteam.initial_team_state(mpc, device="cpu", batch=(B,))
    for a, b in zip(_leaves(ts), _leaves(init)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    s = _common_states(B)
    ts2, _ = tteam.team_step_batch(ts, s.x, -1, TP, mpc, rt.StrategyParams())
    back = rt.dmpc_state_from_numpy(rt.dmpc_state_to_numpy(ts2),
                                    device="cpu")
    for a, b in zip(_leaves(back), _leaves(ts2)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert ts2.attacker.valid.dtype == torch.bool
    one = rt.dmpc_state_from_numpy(j0.attacker, device="cpu")
    assert one.U.shape == (40,) and one.valid.shape == ()


def _leaves(ts):
    return [a for st in ts for a in st]


def test_one_game_api_matches_the_batch_and_jax():
    """``team_step`` (one game: each player a per-agent compute_control)
    equals the batch on the plain route (team B), and DMPCTeam.execute on
    a flat 22-vector matches JAX's DMPCTeam at N=8 over two steps (team
    A)."""
    mpc, jm = rt.MpcParams(N=8), JMpc(N=8)
    s = _common_states(2, seed=9)
    ts = tteam.initial_team_state(mpc, device="cpu", batch=(2,))
    bts, bu = tteam.team_step_batch(ts, s.x, 1, TP, mpc, rt.StrategyParams(),
                                    "plain")
    for i in range(2):
        one = rt.DmpcTeamState(*(tdm.DmpcState(*(a[i] for a in st))
                                 for st in ts))
        ots, ou = tteam.team_step(one, s.x[i], 1, TP, mpc,
                                  rt.StrategyParams())
        np.testing.assert_allclose(ou.numpy(), bu[i].numpy(), atol=1e-5)
        assert float(ots.defender.h) == float(bts.defender.h[i])
    vec = rt.to_vector(s)[0].numpy()
    for field in (-1,):
        jt = jteam.DMPCTeam(JP, field, mpc=jm)
        tt = rt.DMPCTeam(TP, field, mpc=mpc, device="cpu")
        for _ in range(2):
            ja, jd = jt.execute(vec.astype(np.float32))
            ta, td = tt.execute(vec)
            assert ta.shape == td.shape == (2,)
            np.testing.assert_allclose(ta, np.asarray(ja), atol=ATOL,
                                       rtol=RTOL)
            np.testing.assert_allclose(td, np.asarray(jd), atol=ATOL,
                                       rtol=RTOL)
    player = rt.DMPCPlayer(TP, mpc, rt.StrategyParams(), -1,
                           tteam.ATTACKER, device="cpu")
    assert player.get_action(tteam.OFFENSE, vec).shape == (2,)


def test_dmpc_matchup_runs_through_monte_carlo_and_keeps_its_carry():
    """dmpc_matchup against a DMPC team (with the CBF filter) and against
    the no-op team, as monte_carlo policies on the CPU (fused route, K3's
    plain version, at N=8)."""
    B, steps = 2, 3
    mpc = rt.MpcParams(N=8)
    for opp, cbf in (("dmpc", rt.CbfParams()), ("noop", None)):
        policy, ps = rt.dmpc_matchup(TP, B, opp, mpc, cbf=cbf, device="cpu")
        assert (ps[1] is None) == (opp == "noop")
        final, carry = tmc._run_batch(_common_states(B), TP, steps, policy,
                                      ps, device="cpu")
        assert isinstance(carry[0], rt.DmpcTeamState)
        assert carry[0].attacker.U.shape == (B, 16)
        assert bool(carry[0].attacker.valid.all())
        assert bool(torch.isfinite(final.x).all())
        np.testing.assert_allclose(final.t.numpy(), steps * TP.dt, rtol=1e-5)
    with pytest.raises(ValueError, match="opponent"):
        rt.dmpc_matchup(TP, B, "classical", device="cpu")
