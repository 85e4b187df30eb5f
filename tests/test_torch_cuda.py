"""K1's CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device (marker ``cuda``); without one they skip.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

The kernel is built with -fmad=false and IEEE division and square root,
so it runs the plain version's f32 operations in the same order: the two
are held to be equal bitwise, which also covers chaotic grinding games."""

import importlib

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
