"""The CUDA kernels K1, K2 and K3 against their plain PyTorch versions, on
the card.

These tests need a CUDA device (marker ``cuda``); without one they skip.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

The kernels are built with -fmad=false and IEEE division and square
root.  K1 runs its plain version's f32 operations in the same order, so
the two are held to be equal bitwise, which also covers chaotic grinding
games; K2 and K3 are held by tolerance (see their sections below)."""

import importlib

import numpy as np
import pytest
import torch

import robogame_tpu_torch as rt
from robogame_tpu_torch.physics import exact_step as ex

pytestmark = pytest.mark.cuda

mc = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")
P1 = rt.SimParams(engine="pallas_exact", two_phase=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corner_states(dev, B, steps):
    g = torch.Generator().manual_seed(1)
    u = (torch.randint(0, 2, (B, 1, 2), generator=g) * 16.0
         - 8.0).expand(B, 4, 2).contiguous().to(dev)
    s = mc._initial_states(P1, rt.McParams(num_runs=B, randomize_x0=True),
                           dev)
    for _ in range(steps):
        s = rt.step_batch(s, u, P1, device=dev)
    return s, u


def _plain(params, dev, planes, u, mode, cap, noise=None, rnoise=None,
           grid=None, carry=None):
    T = ex._tabs(params, dev)
    return ex.exact_step_plain(T, planes[0], u, planes[1], planes[2], noise,
                               rnoise, grid, carry, mode, cap)


@pytest.mark.parametrize("stochastic", [False, True])
def test_kernel_equals_plain_in_every_mode(dev, stochastic):
    from robogame_tpu_torch import kernels
    B = 256
    s, u = _corner_states(dev, B, 27)
    p = P1.replace(stochastic=stochastic, noise=1.0 if stochastic else 0.0)
    planes = ex._to_planes(s)
    up = ex._u_plane(u, B)
    npl = rpl = None
    if stochastic:
        npl, rpl, _ = ex._noise_planes(s, p)
    T = ex._tabs(p, dev)
    n0 = dict(kernels.launches)
    for mode, cap in (("exact", 49), ("exact_export", 1)):
        k = kernels.exact_step(T.M6, T.consts, planes[0], up, planes[1],
                               planes[2], npl, rpl, None, None, mode, cap)
        q = _plain(p, dev, planes, up, mode, cap, npl, rpl)
        assert torch.equal(k[0], q[0]) and torch.equal(k[1], q[1])
        if mode == "exact_export":
            assert torch.equal(k[2], q[2]) and torch.equal(k[3], q[3])
            kr = kernels.exact_step(T.M6, T.consts, planes[0], up,
                                    planes[1], planes[2], None, rpl, k[2],
                                    k[3], "exact_resume", 48)
            qr = _plain(p, dev, planes, up, "exact_resume", 48, None, rpl,
                        q[2], q[3])
            assert torch.equal(kr[0], qr[0]) and torch.equal(kr[1], qr[1])
    assert kernels.launches["exact"] == n0["exact"] + 1
    assert kernels.launches["exact_resume"] == n0["exact_resume"] + 1


def test_twophase_equals_one_phase_in_the_kernel(dev):
    B = 256
    s, u = _corner_states(dev, B, 28)
    p2 = P1.replace(two_phase=True, compact_frac=B // ex.BLOCK)
    a = rt.step_batch(s, u, P1, device=dev)
    b = rt.step_batch(s, u, p2, device=dev)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_step_batch_on_the_card_equals_the_cpu(dev):
    B = 64
    s, u = _corner_states(dev, B, 26)
    a = rt.step_batch(s, u, P1.replace(two_phase=True), device=dev)
    c = rt.step_batch(rt.GameState(*(t.cpu() for t in s)), u.cpu(),
                      P1.replace(two_phase=True), device="cpu")
    for x, y in zip(a, c):
        assert torch.equal(x.cpu(), y)
    with pytest.raises(ValueError):
        rt.step_batch(s, u, P1, device="cpu")


# ---------------------------------------------------------------------------
# K2: the dense ADMM QP kernel against its plain version
# ---------------------------------------------------------------------------
#
# K2 sums in another order than torch's batched products, so it is held to
# the plain version by tolerance (x within 2e-3 + 1e-2 |x| where both
# converged, flags agreeing on >= 99% of the problems), not bitwise.

def _qps(dev, P, n, m, G=None, n_eq=0, seed=0):
    rng = np.random.default_rng(seed)
    G = P if G is None else G
    Q = rng.normal(size=(G, n, n))
    H = np.einsum("bij,bkj->bik", Q, Q) / n + np.eye(n) / 10.0
    lo = rng.uniform(-2.0, 0.0, (P, m))
    hi = rng.uniform(0.1, 2.0, (P, m))
    lo[:, :n_eq] = hi[:, :n_eq] = rng.uniform(-0.5, 0.5, (P, n_eq))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        H, rng.normal(size=(P, n)), rng.normal(size=(G, m, n)), lo, hi)]


@pytest.mark.parametrize("P,n,m,G,n_eq,scale_rows,iters", [
    (16 * 640, 30, 60, 16, 0, False, 60),     # the skills, shared H and A
    (512, 8, 20, None, 0, False, 50),          # the CBF filter
    (1024, 40, 140, None, 4, True, 60),        # DMPC's shape
    (64, 64, 256, None, 0, False, 20),         # the largest supported
])
def test_k2_agrees_with_plain(dev, P, n, m, G, n_eq, scale_rows, iters):
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.ops import qp, qp_lanes
    H, g, A, lo, hi = _qps(dev, P, n, m, G, n_eq)
    group = P // H.shape[0]
    before = kernels.qp_launches.get((n, m), 0)
    k = qp_lanes.solve_qp_lanes(H, g, A, lo, hi, iters=iters, group=group,
                                scale_rows=scale_rows)
    assert kernels.qp_launches[(n, m)] == before + 1
    p = qp.solve_qp(H.repeat_interleave(group, 0), g,
                    A.repeat_interleave(group, 0), lo, hi, iters=iters,
                    scale_rows=scale_rows)
    torch.cuda.synchronize()
    assert float((k.converged == p.converged).float().mean()) >= 0.99
    both = k.converged & p.converged
    assert bool((k.x - p.x).abs()[both].le(
        2e-3 + 1e-2 * p.x.abs()[both]).all())


def test_k2_shared_operands_equal_broadcast_bitwise(dev):
    from robogame_tpu_torch.ops import qp_lanes
    H, g, A, lo, hi = _qps(dev, 16 * 256, 30, 60, G=16, seed=3)
    a = qp_lanes.solve_qp_lanes(H, g, A, lo, hi, iters=60, group=256)
    b = qp_lanes.solve_qp_lanes(H.repeat_interleave(256, 0), g,
                                A.repeat_interleave(256, 0), lo, hi,
                                iters=60)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_k2_refuses_unsupported_shapes(dev):
    from robogame_tpu_torch.ops import qp_lanes
    for n, m in ((65, 10), (8, 257)):
        H, g, A, lo, hi = _qps(dev, 4, n, m)
        with pytest.raises(ValueError, match="K2 supports"):
            qp_lanes.solve_qp_lanes(H, g, A, lo, hi)


def test_classical_cbf_policy_on_the_card_equals_the_cpu(dev):
    """Eight games, five steps of the classical_cbf matchup on the card
    from the CPU's states: plays equal and controls within 2e-3 + 1e-3 |u|
    (a near-tie of two final times could flip a plan; none does here)."""
    p = rt.SimParams(dt=0.05, winning_score=4, engine="pallas_exact")
    B = 8
    policy, ps = rt.classical_matchup(p, B, cbf=rt.CbfParams(),
                                      device="cpu")
    s = mc._initial_states(p, rt.McParams(num_runs=B, randomize_x0=True,
                                          x0_pos_range=(1.0, 0.5),
                                          x0_vel_range=2.0), "cpu")
    from robogame_tpu_torch.agents import classical as cl
    for _ in range(5):
        gps = tuple(cl._map(lambda a: a.to(dev), t) for t in ps)
        gs = rt.GameState(*(a.to(dev) for a in s))
        (ga, gb), gu = policy(gps, gs)
        ps, u = policy(ps, s)
        assert torch.equal(ga.curr_play.cpu(), ps[0].curr_play)
        assert torch.equal(gb.curr_play.cpu(), ps[1].curr_play)
        assert bool(((gu.cpu() - u).abs() <= 2e-3 + 1e-3 * u.abs()).all())
        s = rt.step_batch(s, u, p, device="cpu")


# ---------------------------------------------------------------------------
# K3: the fused DMPC SQP kernel against its plain version and against K2
# ---------------------------------------------------------------------------
#
# Held by tolerance, as K2: flags agree on >= 99% of the candidates, and
# where both converged x lies within 2e-3 + 1e-2 |x| on all but 2% of them
# (a stopped ADMM iterate moves along the flat directions of H, rank 4
# plus 0.02 I, and the nonconvex relinearization carries that on: the
# plain version in f32 lies outside that tolerance of its f64 run on about
# 0.5% of them, chip_smoke.py phase 6 (b)).

def _dmpc_candidates(dev, Bq, N, seed=0, t_grid=8):
    """Random DMPC instances (arena-scale positions, targets and
    obstacles) through the controller's candidate grid and closed-form QP
    data: the fused solver's inputs for Bq x t_grid candidates."""
    from robogame_tpu_torch.control import dmpc as dm
    rng = np.random.default_rng(seed)

    def pos(*shape):
        return np.stack([rng.uniform(-4.5, 4.5, shape),
                         rng.uniform(-2.2, 2.2, shape)], -1)

    x0 = np.concatenate([pos(Bq), rng.normal(size=(Bq, 2))], 1)
    xd = np.concatenate([pos(Bq), 3.0 * rng.normal(size=(Bq, 2))], 1)
    obs = pos(Bq, 3)
    mpc = rt.MpcParams(N=N, t_grid=t_grid)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    st = dm.initial_dmpc_state(mpc, device=dev, batch=(Bq,))
    return dm, mpc, (st, f(x0), f(xd), f(obs))


def _capture_fused(dm, mpc, inp):
    from robogame_tpu_torch.ops import sqp_lanes
    seen = []
    kernel_route = sqp_lanes.dmpc_sqp_stats

    def hook(*args, **kw):
        seen.append((args, kw))
        return kernel_route(*args, **kw)

    sqp_lanes.dmpc_sqp_stats = hook
    try:
        dm.candidates(*inp, rt.SimParams(), mpc, "fused")
    finally:
        sqp_lanes.dmpc_sqp_stats = kernel_route
    return seen[0]


def test_k3_agrees_with_plain(dev):
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.ops import sqp_lanes
    torch.backends.cuda.matmul.allow_tf32 = False
    dm, mpc, inp = _dmpc_candidates(dev, 256, 20)
    args, kw = _capture_fused(dm, mpc, inp)
    before = kernels.sqp_launches.get((40, 100), 0)
    xk, sk = sqp_lanes.dmpc_sqp_stats(*args, **kw)
    assert kernels.sqp_launches[(40, 100)] == before + 1
    xp, sp = sqp_lanes._plain_stats(*args, **kw)
    torch.cuda.synchronize()
    ck, cp = sk[:, 0] > 0.5, sp[:, 0] > 0.5
    assert float((ck == cp).float().mean()) >= 0.99
    both = ck & cp
    off = both & ((xk - xp).abs() > 2e-3 + 1e-2 * xp.abs()).any(-1)
    assert int(off.sum()) <= 0.02 * int(both.sum())
    assert bool(torch.isfinite(xk).all()) and float(ck.float().mean()) > 0.5


def test_k3_one_sqp_iteration_agrees_with_k2(dev):
    """sqp_rest = 0: the fused solve is one cold scaled QP solve, the same
    algorithm as K2 on the controller's 'lanes' route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dm, mpc, inp = _dmpc_candidates(dev, 256, 20, seed=1)
    one = mpc.replace(sqp_iters=1)
    cf = dm.candidates(*inp, rt.SimParams(), one, "fused")
    cl = dm.candidates(*inp, rt.SimParams(), one, "lanes")
    torch.cuda.synchronize()
    assert float((cf.conv == cl.conv).float().mean()) >= 0.99
    both = cf.conv & cl.conv
    off = both & ((cf.U - cl.U).abs() > 2e-3 + 1e-2 * cl.U.abs()).any(-1)
    assert int(off.sum()) <= 0.02 * int(both.sum())


def test_k3_refuses_unsupported_shapes(dev):
    from robogame_tpu_torch.ops import sqp_lanes
    for N in (6, 36):              # n1 = 12 (n1 % 8 != 0), n1 = 72 (> 64)
        dm, mpc, inp = _dmpc_candidates(dev, 2, N, t_grid=2)
        with pytest.raises(ValueError, match="K3 supports"):
            dm.candidates(*inp, rt.SimParams(), mpc, "fused")
    with pytest.raises(ValueError, match="CPU tensors only"):
        dm.candidates(*inp, rt.SimParams(), mpc, "plain")
    assert sqp_lanes.MAX_N1 == 64
