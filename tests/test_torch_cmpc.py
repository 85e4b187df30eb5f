"""The port's CMPC controller and the plain versions of K4 and K5 against
the JAX package's, on the same inputs made with numpy (f32 on both sides).

* The QP data: ``_prepare_fused`` at N=20 over h in {0.0024, 0.05, 0.2},
  and ``_prepare``, ``_keepout_pieces`` and ``_finish`` at N=8, agree
  with JAX's to f32 roundoff (rtol 2e-5, JAX's own pin between the closed
  and the condensed forms, tests/test_sqp_pallas.py).
* K4's plain version (``solve_cmpc_sqp_lanes`` on CPU tensors) against
  JAX's ``solve_cmpc_sqp_lanes`` in interpret mode, the kernel of JAX's
  fused route, at N=4 on the fused route's own inputs: flags equal on all
  but one problem in eight, x within 2e-3 + 1e-2 |x| where both converged.
* ``route="plain"`` against JAX's XLA route (``use_lanes=False``) at N=8
  (2 SQP iterations of 80 ADMM iterations), cold and warm: controls
  within 2e-3 + 1e-2 |u| and equal warm states, outside argmin near-ties
  (best two step sizes' costs within NEAR_TIE), which are counted.

K5's plain version, the per-team ``compute_control`` and the routes'
agreement inside the port are held in tests/test_torch_cmpc_team.py (each
file stays under 30 s alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import MpcParams as JMpc
from robogame_tpu.config import SimParams as JParams
from robogame_tpu.control import cmpc as jcm
from robogame_tpu.ops.sqp_pallas import solve_cmpc_sqp_lanes as j_sqp

import robogame_tpu_torch as rt
from robogame_tpu_torch.agents import centralized as tct
from robogame_tpu_torch.control import cmpc as tcm
from robogame_tpu_torch.control.dmpc import runner_up_gap
from robogame_tpu_torch.ops import qp_lanes, sqp_lanes

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _inference_mode():
    """Nothing here is differentiated: the module's torch work runs in
    inference mode, without autograd's per-operation bookkeeping."""
    with torch.inference_mode():
        yield

JP = JParams(dtype="float32")
TP = rt.SimParams(dtype="float32")
NEAR_TIE = 1e-3
X_ATOL, X_RTOL = 2e-3, 1e-2
SQP_N = 4                      # K4's interpret-mode reference: n1 = 8


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


def _jax_state(Bq, mpc):
    st = jcm.initial_cmpc_state(mpc)
    return jcm.CmpcState(U=jnp.zeros((Bq, 4 * mpc.N), jnp.float32),
                         valid=jnp.zeros((Bq,), bool),
                         h=jnp.zeros((Bq,), st.h.dtype))


# one jitted JAX reference for the three step sizes
_j_prepare_fused = jax.jit(jax.vmap(lambda a, b, c, d: jcm._prepare_fused(
    a, b, c, d, JP, JMpc())))
_j_finish_fused = jax.jit(jax.vmap(lambda u, p: jcm._finish_fused(
    u, p, JP, JMpc())))


@pytest.mark.parametrize("h", [0.0024, 0.05, 0.2])
def test_prepare_fused_matches_jax(h):
    mpc = rt.MpcParams()
    x1, x2, f1, f2, obs = _instances(4, int(h * 1e4))
    x0, xd = np.concatenate([x1, x2], 1), np.concatenate([f1, f2], 1)
    hs = np.full((4,), h, np.float32)
    ref = _j_prepare_fused(*_j(hs, x0, xd, obs))
    got = tcm._prepare_fused(*_t(hs, x0, xd, obs), TP, mpc)
    for f in tcm.CmpcFusedPieces._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=2e-5,
                                   atol=2e-6, err_msg=f)
    U = np.random.default_rng(5).uniform(-12, 12, (4, 80)).astype(np.float32)
    jU, jc = _j_finish_fused(jnp.asarray(U), ref)
    tU, tc = tcm._finish_fused(torch.from_numpy(U), got, TP, mpc)
    np.testing.assert_array_equal(tU.numpy(), np.asarray(jU))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5)


def test_prepare_keepout_finish_match_jax():
    """The condensed joint form (on the port's batched ``condense``), the
    per-player keepout and pair rows at a random iterate, and the clipped
    candidate cost, at N=8."""
    mpc, jm = rt.MpcParams(N=8), JMpc(N=8)
    x1, x2, f1, f2, obs = _instances(6, 3)
    x0, xd = np.concatenate([x1, x2], 1), np.concatenate([f1, f2], 1)
    hs = np.asarray([0.0024, 0.01, 0.03, 0.08, 0.15, 0.2], np.float32)
    U = np.random.default_rng(4).uniform(-12, 12, (6, 32)).astype(np.float32)
    jprep = jax.jit(jax.vmap(lambda a, b, c, d: jcm._prepare(
        a, b, c, d, JP, jm)))(*_j(hs, x0, xd, obs))
    tprep = tcm._prepare(*_t(hs, x0, xd, obs), TP, mpc)
    for f in ("H", "g", "A_fix", "lo_fix", "hi_fix", "sg1", "sg2", "p0_1",
              "p0_2", "phi_x0", "gam", "gN", "phiN_x0"):
        np.testing.assert_allclose(getattr(tprep, f).numpy(),
                                   np.asarray(getattr(jprep, f)), rtol=2e-5,
                                   atol=2e-5, err_msg=f)
    jk = jax.jit(jax.vmap(lambda u, p: jcm._keepout_pieces(u, p, JP, jm)))(
        jnp.asarray(U), jprep)
    tk = tcm._keepout_pieces(torch.from_numpy(U), tprep, TP, mpc)
    for a, b in zip(tk, jk):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-4)
    rows, rhs = tcm._keepout_all(torch.from_numpy(U), tprep, TP, mpc)
    assert rows.shape == (6, 5 * 8, 32) and rhs.shape == (6, 40)
    jU, jc = jax.jit(jax.vmap(lambda u, p: jcm._finish(u, p, JP, jm)))(
        jnp.asarray(U), jprep)
    tU, tc = tcm._finish(torch.from_numpy(U), tprep, TP, mpc)
    np.testing.assert_array_equal(tU.numpy(), np.asarray(jU))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5)


@pytest.fixture(scope="module")
def sqp_case():
    """Eight CMPC candidates at N=4 through the fused route's closed-form
    data, a random first linearization point, and JAX's interpret-mode K4
    on them (the one interpret-mode compile of K4)."""
    mpc = rt.MpcParams(N=SQP_N, t_grid=2, t_local=0)
    x1, x2, f1, f2, obs = _t(*_instances(4, 7))
    x0, xd = torch.cat([x1, x2], 1), torch.cat([f1, f2], 1)
    st = tcm.initial_cmpc_state(mpc, device="cpu", batch=(4,))
    minT, maxT = tcm._grid(TP, mpc)
    hs = tcm.candidate_steps(minT, maxT, 2, 0, st.h, st.valid).reshape(-1)
    rep = lambda a: a.repeat_interleave(2, 0)
    p = tcm._prepare_fused(hs, rep(x0), rep(xd), rep(obs), TP, mpc)
    two = lambda a: a[:, None].expand((8, 2) + a.shape[1:]).contiguous()
    n1 = 2 * SQP_N
    lx = torch.full((8, 2 * n1), -TP.input_limit)
    U0 = torch.from_numpy(np.random.default_rng(8).uniform(
        -3, 3, (8, 2 * n1)).astype(np.float32))
    args = (two(p.H1), p.g, two(p.sg1), p.p0, p.obs, p.loa, p.hia, lx, -lx,
            U0)
    kw = dict(N=SQP_N, n_obs=2, n_seg0=4, it0=37, sqp_rest=3, it_rest=40,
              d2=float((2.0 * TP.player_radius) ** 2))
    ref = j_sqp(*_j(*args), **kw)
    return args, kw, ref


def test_k4_plain_matches_jax_interpret(sqp_case):
    args, kw, ref = sqp_case
    got = rt.solve_cmpc_sqp_lanes(*args, **kw)
    plain = rt.solve_cmpc_sqp_plain(*args, **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    rc, gc = np.asarray(ref.converged), got.converged.numpy()
    assert (rc == gc).sum() >= 7 and rc.sum() >= 4
    both = rc & gc
    np.testing.assert_allclose(got.x.numpy()[both], np.asarray(ref.x)[both],
                               atol=X_ATOL, rtol=X_RTOL)
    np.testing.assert_allclose(got.prim_res.numpy()[both],
                               np.asarray(ref.prim_res)[both], rtol=0.1,
                               atol=1e-4)


def _near_ties(c):
    return (runner_up_gap(c) <= NEAR_TIE).numpy()


def test_plain_route_matches_jax_xla_route():
    """Cold, then warm from JAX's winners' states carried over: each team's
    controls and warm state."""
    short = dict(N=8, sqp_iters=2, qp_iters=80)
    mpc, jm = rt.MpcParams(**short), JMpc(**short)
    inst = _instances(6, 11)
    jst = _jax_state(6, jm)
    n_tie = 0
    for _ in range(2):
        tst = tct.cmpc_state_from_numpy(jst, device="cpu")
        jst2, ju1, ju2 = jcm.compute_control_batch(jst, *_j(*inst), JP, jm,
                                                   use_lanes=False)
        c = tcm.candidates(tst, *_t(*inst), TP, mpc, "plain")
        tst2, tu1, tu2 = tcm.select(tst, c)
        ok = ~_near_ties(c)
        n_tie += int((~ok).sum())
        for a, b in ((tu1, ju1), (tu2, ju2), (tst2.U, jst2.U)):
            np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok],
                                       atol=X_ATOL, rtol=X_RTOL)
        np.testing.assert_array_equal(tst2.valid.numpy(),
                                      np.asarray(jst2.valid))
        np.testing.assert_array_equal(tst2.h.numpy()[ok],
                                      np.asarray(jst2.h)[ok])
        jst = jst2
    print(f"near-ties: {n_tie} of 12 instance steps")
    assert n_tie <= 3 and bool(tst2.valid.any())


def test_wrappers_and_routes_check_their_inputs(sqp_case):
    args, kw, _ = sqp_case
    with pytest.raises(ValueError, match="n1 == 2N"):
        sqp_lanes.solve_cmpc_sqp_lanes(*args, **dict(kw, N=5))
    with pytest.raises(ValueError, match="U0 must be"):
        sqp_lanes.solve_cmpc_sqp_lanes(*args[:-1], args[-1][:3], **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sqp_lanes.solve_cmpc_sqp_lanes(*(a.to("meta") for a in args), **kw)
    Hb = torch.eye(6).expand(2, 2, 6, 6)
    with pytest.raises(ValueError, match="n1 % 8"):
        qp_lanes.solve_qp_lanes_joint(Hb, torch.zeros(2, 12),
                                      torch.zeros(2, 2, 5, 6),
                                      torch.zeros(2, 8), torch.ones(2, 8),
                                      torch.zeros(2, 12), torch.ones(2, 12),
                                      m_own=3, m_pair=2)
    with pytest.raises(ValueError, match="Ab must be"):
        qp_lanes.solve_qp_lanes_joint(torch.eye(8).expand(2, 2, 8, 8),
                                      torch.zeros(2, 16),
                                      torch.zeros(2, 2, 4, 8),
                                      torch.zeros(2, 8), torch.ones(2, 8),
                                      torch.zeros(2, 16), torch.ones(2, 16),
                                      m_own=3, m_pair=2)
    inst = _t(*_instances(1, 0))
    mpc = rt.MpcParams(t_grid=2)                 # N=20: n = 80 > 64
    st = tcm.initial_cmpc_state(mpc, device="cpu", batch=(1,))
    with pytest.raises(ValueError, match="route='lanes'"):
        tcm.candidates(st, *inst, TP, mpc, "lanes")
    with pytest.raises(ValueError, match="route must be"):
        tcm.compute_control_batch(st, *inst, TP, mpc, route="xla")
