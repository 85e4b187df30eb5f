"""The port's free-final-time trajectories and CBF safety filter against
the JAX package's, on the same inputs made with numpy (f32 on both sides;
JAX takes its XLA solver route, ``use_lanes=False``).

``min_time_traj_batch`` picks the argmin of 16 candidate costs (+1e6 where
a QP did not converge), so f32 roundoff can flip the choice where two
costs nearly tie.  The chosen final time, length and success are held
equal where the best two costs differ by more than NEAR_TIE; controls are
held within 2e-3 (plus 1e-3 relative: they reach the input limit, 10) on
the common prefix.  The CBF filter is held to 1e-4 with equal flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogame_tpu.config import CbfParams as JCbf
from robogame_tpu.config import SimParams as JParams
from robogame_tpu.control import cbf as jcbf
from robogame_tpu.control import trajopt as jtraj
from robogame_tpu.models import lqsys as jlq

import robogame_tpu_torch as rt
from robogame_tpu_torch.control import cbf as tcbf
from robogame_tpu_torch.control import trajopt as ttraj

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
U_ATOL, U_RTOL = 2e-3, 1e-3


def _reach_problems(seed, B):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-3, 3, (B, 2)).astype(np.float32),
            rng.uniform(-2, 2, (B, 2)).astype(np.float32),
            rng.uniform(-3, 3, (B, 2)).astype(np.float32),
            rng.uniform(-2, 2, (B, 2)).astype(np.float32)]


def _gaps(arrs):
    """Per problem: the gap between the best two candidate costs."""
    _, costs, _, _ = ttraj.candidate_costs(
        *(torch.from_numpy(a) for a in arrs), TP)
    c = np.sort(costs.numpy(), axis=0)
    return c[1] - c[0]


@pytest.mark.parametrize("seed,B", [(5, 5), (9, 12)])
def test_min_time_traj_batch_matches_jax(seed, B):
    arrs = _reach_problems(seed, B)
    ref = jtraj.min_time_traj_batch(*(jnp.asarray(a) for a in arrs), JP,
                                    use_lanes=False)
    got = rt.min_time_traj_batch(*(torch.from_numpy(a) for a in arrs), TP)
    clear = _gaps(arrs) > NEAR_TIE
    print(f"near-ties: {int((~clear).sum())} of {B} problems")
    assert clear.sum() >= B - 1
    for name in ("T", "length", "success"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[clear],
                                      np.asarray(getattr(ref, name))[clear])
    np.testing.assert_allclose(got.u.numpy()[clear],
                               np.asarray(ref.u)[clear], atol=U_ATOL,
                               rtol=U_RTOL)
    assert got.u.shape == (B, 2, ttraj.MAX_TRAJ)
    assert got.length.dtype == torch.int32 and bool(got.success.all())


def test_min_time_traj_single_matches_jax_per_game():
    """The port's one-problem call is the batch call at B=1 on the batch's
    T grid (numpy f64 cast to f32); JAX's per-game function builds its grid
    with jnp.logspace in f32, so T agrees to 1e-6 relative and the playback
    length can move by one at a floor(T/dt) boundary: compare the common
    prefix, at the per-game test's own 6e-3."""
    arrs = _reach_problems(5, 3)
    for i in range(3):
        a = [x[i] for x in arrs]
        ref = jtraj.min_time_traj(*(jnp.asarray(x) for x in a), JP)
        got = rt.min_time_traj(*a, TP, device="cpu")
        assert bool(got.success) == bool(ref.success)
        np.testing.assert_allclose(float(got.T), float(ref.T), rtol=1e-6)
        n1, n2 = int(got.length), int(ref.length)
        assert abs(n1 - n2) <= 1
        n = min(n1, n2)
        np.testing.assert_allclose(got.u.numpy()[:, :n],
                                   np.asarray(ref.u)[:, :n], atol=6e-3)


def test_resample_matches_jax_exactly():
    """The playback buffer: floor(T/dt) and the int32 truncation of t/h run
    in f32 in the same order as JAX's, so the buffers are equal."""
    rng = np.random.default_rng(3)
    B = 64
    U = rng.uniform(-10, 10, (B, ttraj.N_KNOTS, 2)).astype(np.float32)
    T = np.asarray(jtraj.T_MAX * rng.uniform(0.0, 1.0, B),
                   np.float32)
    T[:16] = (ttraj._t_grid(TP)[:16]).astype(np.float32)
    h = T / np.float32(ttraj.N_KNOTS)
    ju, jn = jax.vmap(lambda a, b, c: jtraj._resample(a, b, JP.dt, c))(
        jnp.asarray(U), jnp.asarray(h), jnp.asarray(T))
    tu, tn = ttraj._resample(torch.from_numpy(U), torch.from_numpy(h),
                             TP.dt, torch.from_numpy(T))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def test_t_grid_and_candidate_tables_match_jax():
    """The 16 candidates' final times, H and constraint rows, built as JAX
    builds them inside min_time_traj_batch (f32 ZOH maps, condensed)."""
    grid = ttraj._grid(TP, torch.float32, "cpu")
    Ts = TP.dt * np.logspace(0.0, 1.0, ttraj.T_GRID,
                             base=ttraj.T_MAX / TP.dt)
    np.testing.assert_array_equal(grid.Ts.numpy(), Ts.astype(np.float32))
    sel, plo, phi_hi = jtraj._arena_rows(JP, ttraj.N_KNOTS, jnp.float32)
    N = ttraj.N_KNOTS
    @jax.jit
    def tables(h):
        A, Bm = jlq.exact_ab(h, JP.tau_player, jnp.float32)
        phi, gam = jlq.condense(A, Bm, N)
        gN = gam[4 * (N - 1):]
        return 2.0 * (1e-3 * jnp.eye(2 * N) + 10.0 * gN.T @ gN), phi, gam

    for k, h in enumerate(Ts / N):
        H, phi, gam = tables(np.float32(h))
        np.testing.assert_allclose(grid.H[k].numpy(), np.asarray(H),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grid.A[k, 2 * N:].numpy(),
                                   np.asarray(sel @ gam), atol=1e-5)
        np.testing.assert_allclose(grid.selphi[k].numpy(),
                                   np.asarray(sel @ phi), atol=1e-5)
    np.testing.assert_array_equal(grid.plo.numpy(), np.asarray(plo))
    np.testing.assert_array_equal(grid.phi_hi.numpy(), np.asarray(phi_hi))


# ---------------------------------------------------------------------------
# CBF
# ---------------------------------------------------------------------------

def _cbf_games(seed, B):
    rng = np.random.default_rng(seed)
    p = (rng.uniform(-1, 1, (B, 4, 2)) * np.array([4, 2])).astype(np.float32)
    v = rng.uniform(-3, 3, (B, 4, 2)).astype(np.float32)
    u = rng.uniform(-10, 10, (B, 4, 2)).astype(np.float32)
    return u, p, v


@pytest.mark.parametrize("seed,B", [(4, 5), (8, 24)])
def test_safe_control_batch_matches_jax(seed, B):
    u, p, v = _cbf_games(seed, B)
    # a head-on pair closing fast in the first game
    p[0] = [[-0.5, 0.0], [0.5, 0.0], [3.0, 2.0], [3.0, -2.0]]
    v[0] = [[3.0, 0.0], [-3.0, 0.0], [0.0, 0.0], [0.0, 0.0]]
    ref = jcbf.safe_control_batch(*(jnp.asarray(a) for a in (u, p, v)), JP,
                                  JCbf(), use_lanes=False)
    got = rt.safe_control_batch(*(torch.from_numpy(a) for a in (u, p, v)),
                                TP, rt.CbfParams())
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-4)
    assert float(np.abs(got.u.numpy()[0] - u[0]).max()) > 1.0


def test_cbf_qp_pieces_match_jax():
    u, p, v = _cbf_games(2, 16)
    ref = jax.jit(jax.vmap(lambda a, b, c: jcbf._build_qp(
        a, b, c, JP, JCbf())))(*(jnp.asarray(x) for x in (u, p, v)))
    got = tcbf._build_qp(*(torch.from_numpy(x) for x in (u, p, v)), TP,
                         rt.CbfParams())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-5)


def test_safe_control_single_game_and_inactive_filter():
    """All players separating: no active rows, so u == u_nominal; the
    one-game call equals JAX's per-game safe_control."""
    p = np.array([[-2.0, 1.0], [-2.0, -1.0], [2.0, 1.0], [2.0, -1.0]],
                 np.float32)
    v = np.array([[-1.0, 0.0], [-1.0, 0.0], [1.0, 0.0], [1.0, 0.0]],
                 np.float32)
    u = np.array([[3.0, 1.0], [2.0, -1.0], [-3.0, 0.5], [0.0, 0.0]],
                 np.float32)
    got = tcbf.safe_control(u, p, v, TP, rt.CbfParams(), device="cpu")
    ref = jcbf.safe_control(jnp.asarray(u), jnp.asarray(p), jnp.asarray(v),
                            JP, JCbf())
    assert bool(got.converged) and bool(ref.converged)
    np.testing.assert_allclose(got.u.numpy(), u, atol=1e-3)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-4)
