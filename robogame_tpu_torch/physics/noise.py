"""Per-game standard normals from a counter-based stream, on the games'
device.

Every stochastic step draws each game's noise from a stream fixed by the
game's own key (``GameState.key``, (B, 2) int64 ``[seed, counter]``) and
nothing else, so a game draws the same numbers in any batch.  The JAX
package draws with threefry keys under ``vmap``; torch cannot reproduce
that stream, so the port defines its own:

* **Generator:** Philox4x32-10 (Salmon, Moraes, Dror and Shaw, SC'11):
  multipliers 0xD2511F53 and 0xCD9E8D57, key bumps 0x9E3779B9 and
  0xBB67AE85, ten rounds (Random123's constants; the known answers are in
  ``tests/test_torch_noise_stream.py``).
* **Key:** ``(seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)``.
* **Counter:** ``(block j, (counter + 1) & 0xFFFFFFFF, substream s,
  iteration it)``.
* **Substreams** (``it`` is 0 but for substream 3):

  === ================================ =================================
  s   drawn by                         normals a game, in order
  === ================================ =================================
  0   the populate of K1, K6 and the   G x 4 players x 4
      sweep engine
  1   K1's re-propagation              (G + 1) x 4 players x 4
  2   the event engine's populate      G x 4 RK4 stages x 4 players x 2
  3   the event engine's loop          rn (4 stages x 2 rows x 2), pn
      iteration ``it`` (from 1)        (the same), then sn (G x 4 stages
                                       x 4 players x 2)
  === ================================ =================================

* **Normals** (Box-Muller, u1 in (0, 1] so that log never sees 0, in
  f64): for an f32 result block j gives normals 4j..4j+3, from
  (u1, u2) = ((w0 + 1) 2^-32, w1 2^-32) the pair
  (r cos 2 pi u2, r sin 2 pi u2) with r = sqrt(-2 log u1), then the same
  from (w2, w3), each rounded to f32; for an f64 result block j gives
  normals 2j, 2j+1 from the 53-bit uniforms u1 = (a + 1) 2^-53,
  u2 = b 2^-53 with a = (w0 << 21) | (w1 >> 11) and
  b = (w2 << 21) | (w3 >> 11).

:func:`game_normals` runs the hand-written CUDA kernel
``csrc/game_noise.cu`` (one launch for the whole batch, a thread a block
of a game) on CUDA tensors and :func:`game_normals_plain` on CPU tensors.
The plain version is PyTorch on int64 tensors: a uint32 product is an
int64 product, which wraps, with its high word ``(p >> 32) & 0xFFFFFFFF``,
so its words are bitwise the kernel's; the card's and the host's log and
sin/cos may part in the last bits of the normals.
"""

from __future__ import annotations

import math

import torch

from ..plain import plain_version

# the substreams (the table above)
POPULATE, REPROPAGATION, EVENT_POPULATE, EVENT_ITERATION = 0, 1, 2, 3

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi


def philox4x32_plain(ctr: torch.Tensor, key: torch.Tensor,
                     rounds: int = 10) -> torch.Tensor:
    """Philox4x32 on int64 tensors holding uint32 words: ctr (..., 4) and
    key (..., 2), broadcast against each other; returns (..., 4)."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key.unbind(-1)
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK
            k1 = (k1 + PHILOX_W[1]) & _MASK
        p0 = c0 * PHILOX_M[0]
        p1 = c2 * PHILOX_M[1]
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK) ^ c1 ^ k0, p1 & _MASK,
                          ((p0 >> 32) & _MASK) ^ c3 ^ k1, p0 & _MASK)
    return torch.stack([c0, c1, c2, c3], dim=-1)


def per_block(dtype: torch.dtype) -> int:
    """Normals a Philox block gives: 4 for f32, 2 for f64."""
    if dtype == torch.float32:
        return 4
    if dtype == torch.float64:
        return 2
    raise ValueError(f"normals are drawn in float32 or float64, not {dtype}")


def _box_muller(u1, u2):
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def block_words(keys: torch.Tensor, n_blocks: int, substream: int,
                it: int = 0) -> torch.Tensor:
    """(B, n_blocks, 4) int64 words of blocks 0..n_blocks-1 of each game's
    substream at iteration ``it``."""
    B = keys.shape[0]
    seed, ctr = keys[:, 0], keys[:, 1]
    key = torch.stack([seed & _MASK, (seed >> 32) & _MASK], dim=1)
    j = torch.arange(n_blocks, dtype=torch.int64, device=keys.device)
    counter = torch.stack([
        j[None].expand(B, n_blocks),
        ((ctr + 1) & _MASK)[:, None].expand(B, n_blocks),
        torch.full((B, n_blocks), substream, dtype=torch.int64,
                   device=keys.device),
        torch.full((B, n_blocks), it, dtype=torch.int64, device=keys.device),
    ], dim=-1)
    return philox4x32_plain(counter, key[:, None, :])


@plain_version
def game_normals_plain(keys: torch.Tensor, n: int, substream: int,
                       it: int = 0, dtype=torch.float32) -> torch.Tensor:
    """The kernel's plain version: (B, n) standard normals of each game's
    substream at iteration ``it`` (the module docstring's definition)."""
    per = per_block(dtype)
    B = keys.shape[0]
    n_blocks = -(-n // per)
    wi = block_words(keys, n_blocks, substream, it)
    if dtype == torch.float32:
        u = wi.to(torch.float64) * 2.0 ** -32
        one = 2.0 ** -32
        a = _box_muller(u[..., 0] + one, u[..., 1])
        b = _box_muller(u[..., 2] + one, u[..., 3])
        z = torch.stack([*a, *b], dim=-1).to(torch.float32)
    else:
        hi = (wi[..., 0] << 21) | (wi[..., 1] >> 11)
        lo = (wi[..., 2] << 21) | (wi[..., 3] >> 11)
        one = 2.0 ** -53
        z = torch.stack(_box_muller(hi.to(torch.float64) * one + one,
                                    lo.to(torch.float64) * one), dim=-1)
    return z.reshape(B, n_blocks * per)[:, :n].contiguous()


def game_normals(keys: torch.Tensor, n: int, substream: int, it: int = 0,
                 dtype=torch.float32) -> torch.Tensor:
    """(B, n) standard normals of each game's ``substream`` at iteration
    ``it`` on the keys' device: the kernel on a CUDA tensor (a build or
    launch failure raises), the plain version on a CPU tensor."""
    if keys.device.type == "cuda":
        from .. import kernels
        return kernels.game_normals(keys.contiguous(), n, substream, it,
                                    dtype)
    if keys.device.type != "cpu":
        raise ValueError(f"no draw for keys on {keys.device}")
    return game_normals_plain(keys, n, substream, it, dtype)


def ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest distance between a and b (same shape and float dtype)
    in units in the last place of the larger magnitude: the measure the
    draw kernel is held to its plain version by."""
    m = torch.maximum(a.abs(), b.abs())
    spacing = torch.nextafter(m, torch.full_like(m, float("inf"))) - m
    return float(((a - b).abs() / spacing).max()) if a.numel() else 0.0


def advance_keys(keys: torch.Tensor) -> torch.Tensor:
    """The keys after a stochastic step: each counter advanced by one (no
    host copy, so no sync on the card)."""
    out = keys.clone()
    out[:, 1] += 1
    return out
