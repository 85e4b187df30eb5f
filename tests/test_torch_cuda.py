"""The CUDA kernels K1 and K2 against their plain PyTorch versions, on the
card.

These tests need a CUDA device (marker ``cuda``); without one they skip.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Both kernels are built with -fmad=false and IEEE division and square
root.  K1 runs its plain version's f32 operations in the same order, so
the two are held to be equal bitwise, which also covers chaotic grinding
games; K2 is held by tolerance (see its section below)."""

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
