"""The port's DMPC controller and K3's plain version against the JAX
package's, on the same inputs made with numpy (f32 on both sides).

* The candidate grid, cold and warm, equals JAX's to the bit (both build
  the global grid in f64 and round once).
* The QP data: ``_prepare_fused`` at N=20 over h in {0.0025, 0.05, 0.25},
  and ``_prepare``, ``_keepout`` and ``_finish`` at N=8, agree with JAX's to f32
  roundoff (rtol 2e-5, JAX's own pin between the closed and the condensed
  forms, tests/test_dmpc_fused.py).
* K3's plain version (``solve_dmpc_sqp_lanes`` on CPU tensors) against
  JAX's ``solve_dmpc_sqp_lanes`` in interpret mode at N=4: flags equal on
  all but one problem in eight, x within 2e-3 + 1e-2 |x| where both
  converged: the same ADMM in f32 with sums taken in another order.
* ``route="plain"`` against JAX's XLA route (``use_lanes=False``) at N=8,
  and the per-agent ``compute_control``: controls within 2e-3 + 1e-2 |u|
  and equal warm states, outside argmin near-ties (best two costs within
  NEAR_TIE), which are counted.
* Inside the port, the fused route with one SQP iteration equals the
  'lanes' route (one scaled QP solve) to f32 roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import MpcParams as JMpc
from robogame_tpu.config import SimParams as JParams
from robogame_tpu.control import dmpc as jdm
from robogame_tpu.ops.sqp_pallas import solve_dmpc_sqp_lanes as j_sqp

import robogame_tpu_torch as rt
from robogame_tpu_torch.control import dmpc as tdm
from robogame_tpu_torch.ops import sqp_lanes
from _port_env import port_module  # noqa: F401  (autouse fixture)

JP = JParams(dtype="float32")
TP = rt.SimParams(dtype="float32")
NEAR_TIE = 1e-3
X_ATOL, X_RTOL = 2e-3, 1e-2
SQP_N = 4                      # K3's interpret-mode reference: n1 = 8


def _instances(Bq, seed):
    """Arena-scale states, targets and obstacle sets, numpy f32."""
    rng = np.random.default_rng(seed)

    def pos(*shape):
        return np.stack([rng.uniform(-4.5, 4.5, shape),
                         rng.uniform(-2.2, 2.2, shape)], -1)

    x0 = np.concatenate([pos(Bq), rng.normal(size=(Bq, 2))], 1)
    xd = np.concatenate([pos(Bq), 3.0 * rng.normal(size=(Bq, 2))], 1)
    return [a.astype(np.float32) for a in (x0, xd, pos(Bq, 3))]


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(np.asarray(a)) for a in arrs]


def _jax_state(Bq, mpc, valid=False, h=0.0, U=None):
    st = jdm.initial_dmpc_state(mpc)
    U = np.zeros((Bq, 2 * mpc.N), np.float32) if U is None else U
    return jdm.DmpcState(U=jnp.asarray(U),
                         valid=jnp.full((Bq,), valid),
                         h=jnp.full((Bq,), h, st.h.dtype))


def test_candidate_steps_match_jax_bitwise():
    h_prev = np.asarray([0.0, 0.003, 0.02, 0.2, 0.3], np.float32)
    valid = np.asarray([False, True, True, True, True])
    for N, t_grid, t_local in ((20, 8, 4), (20, 8, 0), (8, 6, 1), (4, 2, 1)):
        minT, maxT = 0.05 / N, 5.0 / N
        ref = jax.jit(jax.vmap(lambda h, v: jdm.candidate_steps(
            minT, maxT, t_grid, t_local, h, v, jnp.float32)))(
            *_j(h_prev, valid))
        got = tdm.candidate_steps(minT, maxT, t_grid, t_local,
                                  *_t(h_prev, valid))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("h", [0.0025, 0.05, 0.25])
def test_prepare_fused_matches_jax(h):
    mpc = rt.MpcParams()
    x0, xd, obs = _instances(4, int(h * 1e4))
    hs = np.full((4,), h, np.float32)
    ref = jax.jit(jax.vmap(lambda a, b, c, d: jdm._prepare_fused(
        a, b, c, d, JP, JMpc())))(*_j(hs, x0, xd, obs))
    got = tdm._prepare_fused(*_t(hs, x0, xd, obs), TP, mpc)
    for f in tdm.FusedPieces._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=2e-5,
                                   atol=2e-6, err_msg=f)


def test_prepare_keepout_finish_match_jax():
    """The condensed form (on the port's batched ``condense``), the
    linearized keepout rows at a random iterate, and the clipped
    candidate cost, at N=8."""
    mpc, jm = rt.MpcParams(N=8), JMpc(N=8)
    x0, xd, obs = _instances(6, 3)
    hs = np.asarray([0.00625, 0.01, 0.03, 0.08, 0.15, 0.625], np.float32)
    U = np.random.default_rng(4).uniform(-12, 12, (6, 16)).astype(np.float32)
    jprep = jax.jit(jax.vmap(lambda a, b, c, d: jdm._prepare(
        a, b, c, d, JP, jm)))(*_j(hs, x0, xd, obs))
    tprep = tdm._prepare(*_t(hs, x0, xd, obs), TP, mpc)
    for f in ("H", "g", "A_fix", "lo_fix", "hi_fix", "sg", "p0p", "phi_x0",
              "gam", "gN", "phiN_x0"):
        np.testing.assert_allclose(getattr(tprep, f).numpy(),
                                   np.asarray(getattr(jprep, f)), rtol=2e-5,
                                   atol=2e-5, err_msg=f)
    jrows, jrhs = jax.jit(jax.vmap(lambda u, p: jdm._keepout(
        u, p, JP, jm)))(jnp.asarray(U), jprep)
    trows, trhs = tdm._keepout(torch.from_numpy(U), tprep, TP, mpc)
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(trhs.numpy(), np.asarray(jrhs), rtol=2e-5,
                               atol=2e-4)
    jU, jc = jax.jit(jax.vmap(lambda u, p: jdm._finish(u, p, JP, jm)))(
        jnp.asarray(U), jprep)
    tU, tc = tdm._finish(torch.from_numpy(U), tprep, TP, mpc)
    np.testing.assert_array_equal(tU.numpy(), np.asarray(jU))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5)


@pytest.fixture(scope="module")
def sqp_case():
    """Eight DMPC candidates at N=4 through the closed-form QP data, a
    random first linearization point, and JAX's interpret-mode K3 on them
    (the one interpret-mode compile of this file)."""
    mpc = rt.MpcParams(N=SQP_N, t_grid=2, t_local=0)
    x0, xd, obs = _t(*_instances(4, 7))
    st = tdm.initial_dmpc_state(mpc, device="cpu", batch=(4,))
    hs = tdm.candidate_steps(0.05 / SQP_N, 5.0 / SQP_N, 2, 0, st.h,
                             st.valid).reshape(-1)
    rep = lambda a: a.repeat_interleave(2, 0)
    p = tdm._prepare_fused(hs, rep(x0), rep(xd), rep(obs), TP, mpc)
    xy = lambda a: a.reshape(-1, SQP_N, 2).transpose(1, 2).reshape(
        -1, 2 * SQP_N)
    U0 = torch.from_numpy(np.random.default_rng(8).uniform(
        -3, 3, (8, 2 * SQP_N)).astype(np.float32))
    args = (p.H, p.g, p.sg, p.p0p, p.obs, xy(p.lo_fix[:, 2 * SQP_N:]),
            xy(p.hi_fix[:, 2 * SQP_N:]), p.lo_fix[:, :2 * SQP_N],
            p.hi_fix[:, :2 * SQP_N], U0)
    kw = dict(N=SQP_N, n_obs=3, n_seg0=4, it0=37, sqp_rest=3, it_rest=40,
              d2=float((2.0 * TP.player_radius) ** 2))
    ref = j_sqp(*_j(*args), **kw)
    return args, kw, ref


def test_sqp_plain_matches_jax_interpret(sqp_case):
    args, kw, ref = sqp_case
    got = sqp_lanes.solve_dmpc_sqp_lanes(*args, **kw)
    plain = sqp_lanes.solve_dmpc_sqp_plain(*args, **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    rc = np.asarray(ref.converged)
    gc = got.converged.numpy()
    assert (rc == gc).sum() >= 7 and rc.sum() >= 4
    both = rc & gc
    np.testing.assert_allclose(got.x.numpy()[both], np.asarray(ref.x)[both],
                               atol=X_ATOL, rtol=X_RTOL)
    np.testing.assert_allclose(got.prim_res.numpy()[both],
                               np.asarray(ref.prim_res)[both], rtol=0.1,
                               atol=1e-4)


def _near_ties(c):
    srt = np.sort(c.cost.numpy(), axis=1)
    return (srt[:, 1] - srt[:, 0]) <= NEAR_TIE


def test_plain_route_matches_jax_xla_route():
    """Cold and warm (the JAX winners' warm states carried over): the
    winners' controls and warm states per instance."""
    mpc, jm = rt.MpcParams(N=8), JMpc(N=8)
    x0, xd, obs = _instances(6, 11)
    jst = _jax_state(6, jm)
    n_tie = 0
    for _ in range(2):
        tst = rt.dmpc_state_from_numpy(jst, device="cpu")
        jst2, ju = jdm.compute_control_batch(jst, *_j(x0, xd, obs), JP, jm,
                                             use_lanes=False)
        c = tdm.candidates(tst, *_t(x0, xd, obs), TP, mpc, "plain")
        tst2, tu = tdm.select(tst, c)
        ok = ~_near_ties(c)
        n_tie += int((~ok).sum())
        np.testing.assert_allclose(tu.numpy()[ok], np.asarray(ju)[ok],
                                   atol=X_ATOL, rtol=X_RTOL)
        np.testing.assert_array_equal(tst2.valid.numpy(),
                                      np.asarray(jst2.valid))
        np.testing.assert_array_equal(tst2.h.numpy()[ok],
                                      np.asarray(jst2.h)[ok])
        np.testing.assert_allclose(tst2.U.numpy()[ok], np.asarray(jst2.U)[ok],
                                   atol=X_ATOL, rtol=X_RTOL)
        jst = jst2
    print(f"near-ties: {n_tie} of 12 instance steps")
    assert n_tie <= 3 and bool(tst2.valid.all())


def test_compute_control_single_agent_matches_jax():
    """The per-agent entry (a cold QP solve per SQP iteration on the
    plain solver) against JAX's per-agent compute_control."""
    mpc, jm = rt.MpcParams(N=8), JMpc(N=8)
    x0, xd, obs = _instances(2, 12)
    for i in range(2):
        jst, ju = jdm.compute_control(jdm.initial_dmpc_state(jm),
                                      *_j(x0[i], xd[i], obs[i]), JP, jm)
        tst, tu = tdm.compute_control(
            tdm.initial_dmpc_state(mpc, device="cpu"),
            *_t(x0[i], xd[i], obs[i]), TP, mpc)
        assert tu.shape == (2,) and tst.U.shape == (16,)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=X_ATOL,
                                   rtol=X_RTOL)
        assert bool(tst.valid) == bool(jst.valid)
        np.testing.assert_allclose(float(tst.h), float(jst.h), rtol=1e-6)


def test_fused_one_sqp_iteration_equals_lanes_route():
    """sqp_iters=1: K3's algorithm is one cold scaled QP solve, the same as
    K2's on the 'lanes' route (the box rows implicit instead of identity
    rows of unit norm), so the candidates agree to f32 roundoff."""
    mpc = rt.MpcParams(N=8, sqp_iters=1)
    x0, xd, obs = _t(*_instances(6, 13))
    st = tdm.initial_dmpc_state(mpc, device="cpu", batch=(6,))
    cf = tdm.candidates(st, x0, xd, obs, TP, mpc, "fused")
    cl = tdm.candidates(st, x0, xd, obs, TP, mpc, "lanes")
    assert torch.equal(cf.conv, cl.conv) and bool(cf.conv.any())
    both = cf.conv
    np.testing.assert_allclose(cf.U.numpy()[both.numpy()],
                               cl.U.numpy()[both.numpy()], atol=2e-4,
                               rtol=1e-3)
    assert cf.margin.shape == (6, mpc.t_grid) and cl.margin is None
    assert bool((cf.margin[cf.conv] < 1).all())


def test_sqp_wrapper_and_routes_check_their_inputs(sqp_case):
    args, kw, _ = sqp_case
    with pytest.raises(ValueError, match="n1 == 2N"):
        sqp_lanes.solve_dmpc_sqp_lanes(*args, **dict(kw, N=5))
    with pytest.raises(ValueError, match="U0 must be"):
        sqp_lanes.solve_dmpc_sqp_lanes(*args[:-1], args[-1][:3], **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sqp_lanes.solve_dmpc_sqp_lanes(*(a.to("meta") for a in args), **kw)
    mpc = rt.MpcParams(N=4, t_grid=2)
    st = tdm.initial_dmpc_state(mpc, device="cpu", batch=(1,))
    with pytest.raises(ValueError, match="route must be"):
        tdm.compute_control_batch(st, *_t(*_instances(1, 0)), TP, mpc,
                                  route="xla")
