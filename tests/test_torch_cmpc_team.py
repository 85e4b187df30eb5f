"""The port's CMPC team and closed-loop policies against the JAX package's,
per control step from common states (f32 on both sides).

A closed loop is chaotic, so nothing free-running is compared: the port's
plain exact step drives the games, and at every step both sides get the
same game state and the same warm CMPC state (JAX's, carried across with
``cmpc_state_from_numpy``).

* The targets equal JAX's ``target_states`` for both fields and plays.
* ``team_step_batch(route="plain")`` against JAX's ``team_step_batch``
  (its XLA route on the CPU) at N=8 with 2 SQP iterations of 80 ADMM
  iterations, B=4 games x 5 steps, both teams: controls within 2e-3 +
  1e-2 |u| and equal warm states (h, valid; U to the same tolerance) per
  team, except where the team's best candidate cost lies within NEAR_TIE
  of another step size's on the port's side (f32 roundoff may pick the
  other candidate); those are counted and bounded.
* The one-game API (``team_step``, ``CentralizedTeam.run`` on a flat
  22-vector: the per-team ``compute_control``, a cold QP solve per SQP
  iteration on the plain solver) against the batch and JAX's
  ``CentralizedTeam``: controls within 2e-3 + 1e-2 |u|, equal warm states.
* ``cmpc_matchup`` and ``dmpc_matchup(opponent="cmpc")`` run through
  ``monte_carlo``'s loop and keep their carries.
* K5's plain version (``solve_qp_lanes_joint`` on CPU tensors), the QP of
  the 'joint' route, against JAX's ``solve_qp_lanes_joint`` in interpret
  mode at n1=8 with row scaling and equality rows: flags equal on all but
  one problem in nine, x within 2e-3 + 1e-2 |x| (the same ADMM in f32 with
  sums taken in another order).
* Inside the port: the fused route with one SQP iteration equals the
  'joint' route (one K5 solve) to f32 roundoff, and the 'joint' and
  'lanes' routes equal the 'plain' route.

The controller's pieces, K4 and the plain route against JAX's XLA route
are held in tests/test_torch_cmpc.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.agents import centralized as jct
from robogame_tpu.config import MpcParams as JMpc
from robogame_tpu.config import SimParams as JParams
from robogame_tpu.control import cmpc as jcm
from robogame_tpu.ops.qp_pallas import solve_qp_lanes_joint as j_joint

import robogame_tpu_torch as rt
from robogame_tpu_torch.agents import centralized as tct
from robogame_tpu_torch.control import cmpc as tcm
from robogame_tpu_torch.control.dmpc import runner_up_gap
from _port_env import port_module  # noqa: F401  (autouse fixture)

tmc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")

JP = JParams(dtype="float32", engine="pallas_exact", winning_score=4)
TP = rt.SimParams(dtype="float32", engine="pallas_exact", winning_score=4)
NEAR_TIE = 1e-3
ATOL, RTOL = 2e-3, 1e-2


def _common_states(B, seed=0):
    """The matchups' randomized puck starts (the port's ``_initial_states``),
    players moved to random spots so that the obstacles vary."""
    s = tmc._initial_states(TP, rt.McParams(
        num_runs=B, randomize_x0=True, x0_pos_range=(1.0, 0.5),
        x0_vel_range=2.0), device="cpu")
    x = s.x.numpy().copy()
    rng = np.random.default_rng(seed)
    x[:, :4, 0] = rng.uniform(-4.5, 4.5, (B, 4))
    x[:, :4, 1] = rng.uniform(-2.2, 2.2, (B, 4))
    x[:, :4, 2:] = rng.normal(size=(B, 4, 2))
    return s._replace(x=torch.from_numpy(x))


def _jax_state(cs):
    return jcm.CmpcState(*map(jnp.asarray, rt.cmpc_state_to_numpy(cs)))


@pytest.mark.parametrize("field", [-1, 1])
def test_target_states_match_jax(field):
    s = _common_states(16, seed=field + 2)
    x = s.x.clone()
    x[:4, 4, 0] = torch.tensor([4.9, -4.9, 0.0, 3.0])   # the puck's halves
    x[:4, 4, 1] = torch.tensor([0.0, 1.0, 0.0, -2.0])
    jx = jnp.asarray(x.numpy())
    for play in (tct.OFFENSE, tct.DEFENSE):
        ref = jax.jit(jax.vmap(lambda p: jct.target_states(
            jnp.asarray(play), p, field, JP)))(jx[:, 4, :2])
        got = tct.target_states(torch.full((16,), play), x[:, 4, :2], field,
                                TP)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    play = torch.zeros(16, dtype=torch.int32)
    xa, xd, ta, td, obs = tct.team_inputs(x, play, field, TP)
    rows = (0, 1, 2, 3) if field < 0 else (2, 3, 0, 1)
    np.testing.assert_array_equal(xa.numpy(), x.numpy()[:, rows[0]])
    np.testing.assert_array_equal(xd.numpy(), x.numpy()[:, rows[1]])
    np.testing.assert_array_equal(obs.numpy(),
                                  x.numpy()[:, list(rows[2:]), 0:2])


def test_team_step_batch_plain_matches_jax_per_step():
    B, steps = 4, 5
    short = dict(N=8, sqp_iters=2, qp_iters=80)
    mpc, jm = rt.MpcParams(**short), JMpc(**short)
    s = _common_states(B)
    teams = {f: tcm.initial_cmpc_state(mpc, device="cpu", batch=(B,))
             for f in (-1, 1)}
    n_tie = 0
    for _ in range(steps):
        us = []
        for field in (-1, 1):
            cs = teams[field]
            jcs, ju = jct.team_step_batch(
                _jax_state(cs), jnp.asarray(s.x.numpy()),
                jnp.asarray(jct.OFFENSE, jnp.int32), field, JP, jm)
            tcs, tu = tct.team_step_batch(cs, s.x, tct.OFFENSE, field, TP,
                                          mpc, "plain")
            play = torch.zeros(B, dtype=torch.int32)
            c = tcm.candidates(cs, *tct.team_inputs(s.x, play, field, TP),
                               TP, mpc, "plain")
            ok = (runner_up_gap(c) > NEAR_TIE).numpy()
            n_tie += int((~ok).sum())
            np.testing.assert_allclose(tu.numpy()[ok], np.asarray(ju)[ok],
                                       atol=ATOL, rtol=RTOL)
            np.testing.assert_array_equal(tcs.valid.numpy(),
                                          np.asarray(jcs.valid))
            np.testing.assert_array_equal(tcs.h.numpy()[ok],
                                          np.asarray(jcs.h)[ok])
            np.testing.assert_allclose(tcs.U.numpy()[ok],
                                       np.asarray(jcs.U)[ok], atol=ATOL,
                                       rtol=RTOL)
            teams[field] = tct.cmpc_state_from_numpy(jcs, device="cpu")
            us.append(tu)
        s = rt.step_batch(s, torch.cat(us, dim=1), TP, device="cpu")
    print(f"near-ties: {n_tie} of {2 * B * steps} team steps")
    assert n_tie <= B * steps // 4
    assert bool(teams[1].valid.all())


def test_cmpc_state_numpy_round_trip():
    B = 3
    mpc = rt.MpcParams()
    j0 = jcm.initial_cmpc_state(JMpc())
    jb = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a), (B,) +
                                                np.shape(a)), j0)
    cs = rt.cmpc_state_from_numpy(jb, device="cpu")
    init = rt.initial_cmpc_state(mpc, device="cpu", batch=(B,))
    for a, b in zip(cs, init):
        assert torch.equal(a, b) and a.dtype == b.dtype
    s = _common_states(B)
    small = mpc.replace(N=8, t_grid=2)
    cs2, _ = tct.team_step_batch(
        rt.initial_cmpc_state(small, device="cpu", batch=(B,)), s.x,
        tct.OFFENSE, -1, TP, small)
    back = rt.cmpc_state_from_numpy(rt.cmpc_state_to_numpy(cs2),
                                    device="cpu")
    for a, b in zip(back, cs2):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert cs2.valid.dtype == torch.bool
    one = rt.cmpc_state_from_numpy(j0, device="cpu")
    assert one.U.shape == (80,) and one.valid.shape == ()


def test_one_game_api_matches_the_batch_and_jax():
    """``team_step`` (one game: the per-team compute_control, a cold QP
    solve per SQP iteration on the plain solver) equals the batch on the
    plain route (team B), and CentralizedTeam.run on a flat 22-vector
    matches JAX's CentralizedTeam (its per-team compute_control) at N=8
    over two steps, controls and warm state (team A)."""
    mpc, jm = rt.MpcParams(N=8), JMpc(N=8)
    s = _common_states(2, seed=9)
    cs = tcm.initial_cmpc_state(mpc, device="cpu", batch=(2,))
    bcs, bu = tct.team_step_batch(cs, s.x, tct.OFFENSE, 1, TP, mpc, "plain")
    for i in range(2):
        one = tcm.CmpcState(*(a[i] for a in cs))
        ocs, ou = tct.team_step(one, s.x[i], tct.OFFENSE, 1, TP, mpc)
        np.testing.assert_allclose(ou.numpy(), bu[i].numpy(), atol=1e-5)
        assert float(ocs.h) == float(bcs.h[i])
    vec = rt.to_vector(s)[0].numpy()
    jt = jct.CentralizedTeam(JP, -1, mpc=jm)
    tt = rt.CentralizedTeam(TP, -1, mpc=mpc, device="cpu")
    for _ in range(2):
        ja, jd = jt.run(vec.astype(np.float32))
        ta, td = tt.run(vec)
        assert ta.shape == td.shape == (2,)
        np.testing.assert_allclose(ta, np.asarray(ja), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(td, np.asarray(jd), atol=ATOL, rtol=RTOL)
        jcs, tcs = jt.players.cs, tt.players.cs
        assert tcs.U.shape == (32,) and bool(tcs.valid) == bool(jcs.valid)
        np.testing.assert_allclose(float(tcs.h), float(jcs.h), rtol=1e-6)
        np.testing.assert_allclose(tcs.U.numpy(), np.asarray(jcs.U),
                                   atol=ATOL, rtol=RTOL)
    player = rt.BaselineCentralizedPlayers(TP, 1, mpc=mpc, device="cpu")
    ua, ud = player.get_action(tct.OFFENSE, vec)
    assert ua.shape == ud.shape == (2,) and player.this_team == "B"


def test_matchups_run_through_monte_carlo_and_keep_their_carry():
    """cmpc_matchup (with the CBF filter) and dmpc_matchup against a CMPC
    team, as monte_carlo policies on the CPU (the fused route, K4's plain
    version, at N=8)."""
    B, steps = 2, 3
    mpc = rt.MpcParams(N=8)
    for name, (policy, ps) in (
            ("cmpc", rt.cmpc_matchup(TP, B, mpc=mpc, cbf=rt.CbfParams(),
                                     device="cpu")),
            ("dmpc", rt.dmpc_matchup(TP, B, "cmpc", mpc, device="cpu"))):
        final, carry = tmc._run_batch(_common_states(B), TP, steps, policy,
                                      ps, device="cpu")
        assert isinstance(carry[1], rt.CmpcState), name
        assert carry[1].U.shape == (B, 32)
        assert bool(carry[1].valid.all())
        assert bool(torch.isfinite(final.x).all())
        np.testing.assert_allclose(final.t.numpy(), steps * TP.dt, rtol=1e-5)
    assert isinstance(carry[0], rt.DmpcTeamState)
    with pytest.raises(ValueError, match="opponent"):
        rt.cmpc_matchup(TP, B, "noop", device="cpu")


def _instances(Bq, seed):
    """Arena-scale states and targets of both players and obstacle pairs,
    numpy f32: x0_p1, x0_p2, xf_p1, xf_p2 (Bq, 4), obstacles (Bq, 2, 2)."""
    rng = np.random.default_rng(seed)

    def pos(*shape):
        return np.stack([rng.uniform(-4.5, 4.5, shape),
                         rng.uniform(-2.2, 2.2, shape)], -1)

    x1 = np.concatenate([pos(Bq), rng.normal(size=(Bq, 2))], 1)
    x2 = np.concatenate([pos(Bq), rng.normal(size=(Bq, 2))], 1)
    f1 = np.concatenate([pos(Bq), 3.0 * rng.normal(size=(Bq, 2))], 1)
    f2 = np.concatenate([pos(Bq), np.zeros((Bq, 2))], 1)
    return [a.astype(np.float32) for a in (x1, x2, f1, f2, pos(Bq, 2))]


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(np.asarray(a)) for a in arrs]


def test_k5_plain_matches_jax_interpret():
    """Random structured problems (SPD blocks, per-player own rows with two
    equality rows each, shared pair rows, a variable box) at n1=8 with row
    scaling: the one interpret-mode compile of K5."""
    rng = np.random.default_rng(21)
    B, n1, m_own, m_pair = 9, 8, 12, 4
    Q = rng.normal(size=(B, 2, n1, n1))
    Hb = np.einsum("bpij,bpkj->bpik", Q, Q) / n1 + np.eye(n1) / 10.0
    g = rng.normal(size=(B, 2 * n1))
    Ab = rng.normal(size=(B, 2, m_own + m_pair, n1))
    R = 2 * m_own + m_pair
    lo = rng.uniform(-2.0, 0.0, (B, R))
    hi = rng.uniform(0.1, 2.0, (B, R))
    for r in (0, 1, m_own, m_own + 1):
        lo[:, r] = hi[:, r] = rng.uniform(-0.5, 0.5, B)
    lx = np.full((B, 2 * n1), -1.5)
    args = [a.astype(np.float32) for a in (Hb, g, Ab, lo, hi, lx, -lx)]
    kw = dict(m_own=m_own, m_pair=m_pair, iters=60, scale_rows=True)
    ref = j_joint(*_j(*args), **kw)
    got = rt.solve_qp_lanes_joint(*_t(*args), **kw)
    plain = rt.solve_qp_lanes_joint_plain(*_t(*args), **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    rc, gc = np.asarray(ref.converged), got.converged.numpy()
    assert (rc == gc).sum() >= 8 and rc.sum() >= 5
    both = rc & gc
    np.testing.assert_allclose(got.x.numpy()[both], np.asarray(ref.x)[both],
                               atol=ATOL, rtol=RTOL)


def test_routes_agree_inside_the_port():
    """sqp_iters=1: K4's algorithm is one cold scaled joint QP solve, the
    same as K5's on the 'joint' route, so the candidates agree to f32
    roundoff; the 'joint' and 'lanes' routes (K5's and K2's plain versions
    with the rows relinearized between solves) equal the 'plain' route to
    the same roundoff at the full SQP."""
    mpc = rt.MpcParams(N=8)
    inst = _t(*_instances(6, 13))
    st = tcm.initial_cmpc_state(mpc, device="cpu", batch=(6,))
    one = mpc.replace(sqp_iters=1)
    cf = tcm.candidates(st, *inst, TP, one, "fused")
    cj = tcm.candidates(st, *inst, TP, one, "joint")
    assert torch.equal(cf.conv, cj.conv) and bool(cf.conv.any())
    both = cf.conv.numpy()
    np.testing.assert_allclose(cf.U.numpy()[both], cj.U.numpy()[both],
                               atol=2e-4, rtol=1e-3)
    assert cf.margin.shape == cj.margin.shape == (6, mpc.t_grid)
    assert bool((cf.margin[cf.conv] < 1).all())
    cp = tcm.candidates(st, *inst, TP, mpc, "plain")
    for route in ("joint", "lanes"):
        c = tcm.candidates(st, *inst, TP, mpc, route)
        assert torch.equal(c.conv, cp.conv), route
        both = c.conv.numpy()
        np.testing.assert_allclose(c.U.numpy()[both], cp.U.numpy()[both],
                                   atol=ATOL, rtol=RTOL, err_msg=route)
    assert cp.margin is None
