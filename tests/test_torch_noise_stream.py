"""The port's per-game noise stream (``physics/noise.py``): Philox4x32-10
against Random123's published known answers and against a pure-Python
Philox and Box-Muller written here from the same definition, the
substreams' disjointness, the normals' mean and covariance, a game's
draws independent of the rest of its batch, and the draw paths of the
engines built on it.  The kernel's own tests are in
``tests/test_torch_cuda.py`` (marker ``cuda``)."""

import math

import numpy as np
import pytest
import torch

import robogame_tpu_torch as rt
from robogame_tpu_torch.physics import noise
from robogame_tpu_torch.physics import engine as tengine
from robogame_tpu_torch.physics.sweep import game_draws
from _port_env import port_module  # noqa: F401  (autouse fixture)

M32 = 0xFFFFFFFF

# Random123's kat_vectors for philox4x32 at 10 rounds: counter, key, out
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def _philox_py(ctr, key):
    """Philox4x32-10 on Python ints, from the SC'11 definition."""
    c, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & M32]
    return c


def _normals_py(seed, counter, n, substream, it, f64):
    """The module docstring's normals of one game, on Python floats."""
    key = (seed & M32, (seed >> 32) & M32)
    out, j = [], 0
    while len(out) < n:
        w = _philox_py((j, (counter + 1) & M32, substream, it), key)
        if f64:
            pairs = [((w[0] << 21) | (w[1] >> 11),
                      (w[2] << 21) | (w[3] >> 11), 2.0 ** -53)]
        else:
            pairs = [(w[0], w[1], 2.0 ** -32), (w[2], w[3], 2.0 ** -32)]
        for a, b, one in pairs:
            r = math.sqrt(-2.0 * math.log(a * one + one))
            out += [r * math.cos(2.0 * math.pi * (b * one)),
                    r * math.sin(2.0 * math.pi * (b * one))]
        j += 1
    return out[:n]


@pytest.mark.parametrize("ctr,key,want", KNOWN_ANSWERS)
def test_philox_known_answers(ctr, key, want):
    got = noise.philox4x32_plain(torch.tensor(ctr), torch.tensor(key))
    assert got.tolist() == list(want)


def test_plain_matches_pure_python_definition():
    """Words bitwise on random counters and keys; each game's normals
    (seeds of both signs and above 2^32, counters up to the wrap) within
    1 ulp of the same definition on Python floats, f32 and f64."""
    rng = np.random.default_rng(3)
    ctr = rng.integers(0, 2 ** 32, (64, 4))
    key = rng.integers(0, 2 ** 32, (64, 2))
    got = noise.philox4x32_plain(torch.from_numpy(ctr), torch.from_numpy(key))
    want = [_philox_py(c.tolist(), k.tolist()) for c, k in zip(ctr, key)]
    assert got.tolist() == want
    keys = torch.tensor([[5, 0], [-7, 3], [2 ** 40 + 9, 2 ** 32 - 1]])
    for f64, dtype in ((False, torch.float32), (True, torch.float64)):
        for s, it in ((0, 0), (3, 7)):
            z = noise.game_normals_plain(keys, 37, s, it, dtype)
            ref = torch.tensor([_normals_py(int(k[0]), int(k[1]), 37, s, it,
                                            f64) for k in keys],
                               dtype=torch.float64).to(dtype)
            assert noise.ulps(z, ref) <= 1.0


def test_substreams_and_iterations_are_disjoint():
    """For one key, no 128-bit block repeats across the four substreams
    and three loop iterations, and the normals of two substreams are
    uncorrelated (|r| < 4 / sqrt(n))."""
    keys = torch.tensor([[11, 4]])
    blocks = set()
    for s, it in ((0, 0), (1, 0), (2, 0), (3, 1), (3, 2), (3, 3)):
        w = noise.block_words(keys, 512, s, it)[0]
        blocks |= {tuple(r) for r in w.tolist()}
    assert len(blocks) == 6 * 512
    n = 40000
    a = noise.game_normals_plain(keys, n, 0).double()[0]
    b = noise.game_normals_plain(keys, n, 1).double()[0]
    assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 4 / n ** .5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_normals_mean_and_covariance(dtype):
    """128 games x 8192 normals: mean within 5 sigma of 0, variance
    within 5 sigma of 1, and the covariance of neighbouring normals (the
    two of a Box-Muller pair, f32's two pairs of a block) within 5 sigma
    of 0."""
    keys = torch.stack([torch.arange(128), torch.full((128,), 9)], dim=1)
    z = noise.game_normals_plain(keys, 8192, 2, 0, dtype).double()
    assert z.dtype == torch.float64 and bool(torch.isfinite(z).all())
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n ** 0.5
    assert abs(float(z.var()) - 1.0) < 5 * (2 / n) ** 0.5
    q = z.reshape(-1, 4)
    cov = torch.cov(q.T)
    off = cov - torch.diag(torch.diag(cov))
    assert float(off.abs().max()) < 5 / q.shape[0] ** 0.5


def test_a_games_draws_do_not_depend_on_its_batch():
    """The same (seed, counter) draws the same numbers in a batch of 64
    and a batch of 3, for every substream, in both dtypes."""
    big = torch.stack([torch.arange(64) * 7 - 30,
                       torch.arange(64) % 5], dim=1)
    pick = [5, 40, 63]
    for dtype in (torch.float32, torch.float64):
        for s, it in ((0, 0), (1, 0), (2, 0), (3, 4)):
            a = noise.game_normals_plain(big, 50, s, it, dtype)[pick]
            b = noise.game_normals_plain(big[pick], 50, s, it, dtype)
            assert torch.equal(a, b)


def test_engine_draws_take_their_substreams():
    """``game_draws`` is substreams 0 and 1 in (B, n, 4, 4) with the keys
    advanced; the event engine's populate is substream 2 and a loop
    iteration substream 3 at its index, w times the normals, zero puck
    rows, zeros for the games not looping."""
    p = rt.SimParams(engine="event", stochastic=True, noise=0.7,
                     grid_points=6)
    s = rt.initial_state(p, seed=[3, 8, 1], device="cpu")
    G, B = p.grid_points, 3
    (xp, xr), keys = game_draws(s, (G, G + 1))
    assert torch.equal(xp, noise.game_normals(s.key, G * 16, 0).view(
        B, G, 4, 4))
    assert torch.equal(xr, noise.game_normals(s.key, (G + 1) * 16, 1).view(
        B, G + 1, 4, 4))
    assert keys.tolist() == [[3, 1], [8, 1], [1, 1]]
    pop = tengine._populate_draws(s.key, p)
    z = noise.game_normals(s.key, G * 32, 2).view(B, G, 4, 4, 2)
    assert pop.shape == (B, G, 4, 5, 2) and not pop[:, :, :, 4].any()
    assert torch.equal(pop[:, :, :, :4], 0.7 * z)
    active = torch.tensor([True, False, True])
    rn, pn, sn = tengine._iteration_draws(s.key, active, 5, p)
    z = 0.7 * noise.game_normals(s.key, 32 + G * 32, 3, 5)
    assert torch.equal(rn[0], z[0, :16].view(4, 2, 2))
    assert torch.equal(pn[2], z[2, 16:32].view(4, 2, 2))
    assert torch.equal(sn[2, :, :, :4], z[2, 32:].view(G, 4, 4, 2))
    assert not sn[:, :, :, 4].any()
    assert not (rn[1].any() or pn[1].any() or sn[1].any())
