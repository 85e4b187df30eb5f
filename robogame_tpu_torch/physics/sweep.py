"""Closed-form sub-step tables and the stochastic noise model.

Between collisions the dynamics are LTI (damped double integrators, input
constant over the control step), so one RK4 sub-step is a constant affine
map ``x' = F x + S u`` and grid column k is ``x_k = F^k x_0 + S_k u``.  The
tables are float64 numpy, built once per parameter set.

Noise: the reference draws fresh normals inside every RK4 stage.  Per
sub-step that is an additive Gaussian with covariance ``w^2 sum_s M_s M_s^T``;
one 4-vector per sub-step is drawn through its Cholesky factor L.  Each
noise function is split in two -- draw standard normals ``xi`` with a
generator, and transform a given ``xi`` -- so tests can feed the same xi to
this port and to the JAX package.

The sweep step itself (``engine="sweep"``) is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import SimParams


def _substep_affine_np(params: SimParams):
    """Per-entity one-substep RK4 affine map (F (5,4,4), S (5,4,2)) plus the
    per-substep stage-noise covariance Cholesky factor L (4,4), float64."""
    h = params.dt_col
    F = np.zeros((5, 4, 4))
    S = np.zeros((5, 4, 2))
    I = np.eye(4)
    N = np.zeros((4, 2))
    N[2, 0] = N[3, 1] = 1.0                      # noise enters on vdot
    cov = np.zeros((4, 4))
    for e in range(5):
        tau, drag = params.taus[e], params.drags[e]
        Ac = np.zeros((4, 4))
        Ac[0, 2] = Ac[1, 3] = 1.0
        Ac[2, 2] = Ac[3, 3] = -drag / tau
        Bc = np.zeros((4, 2))
        Bc[2, 0] = Bc[3, 1] = 1.0 / tau
        hA = h * Ac
        hA2, hA3 = hA @ hA, hA @ hA @ hA
        F[e] = I + hA + hA2 / 2.0 + hA3 / 6.0 + hA3 @ hA / 24.0
        S[e] = h * (I + hA / 2.0 + hA2 / 6.0 + hA3 / 24.0) @ Bc
        if e == 0:  # players all share tau/drag; covariance from player map
            M1 = h / 6.0 * (I + hA + hA2 / 2.0 + hA3 / 4.0) @ N
            M2 = h / 6.0 * (2.0 * I + hA + hA2 / 2.0) @ N
            M3 = h / 6.0 * (2.0 * I + hA) @ N
            M4 = h / 6.0 * N
            for M in (M1, M2, M3, M4):
                cov += M @ M.T
    L = np.linalg.cholesky(cov + 1e-300 * np.eye(4))
    return F, S, L


def _affine_tables_np(params: SimParams):
    """Power tables: Fpow[d] = F^d, Spow[d] = sum_{m<d} F^m S  (d = 0..G),
    so grid column k is  x_k = Fpow[k] x_0 + Spow[k] u."""
    G = params.grid_points
    F, S, L = _substep_affine_np(params)
    Fpow = np.zeros((G + 1, 5, 4, 4))
    Spow = np.zeros((G + 1, 5, 4, 2))
    Fpow[0] = np.eye(4)
    for d in range(1, G + 1):
        Fpow[d] = np.einsum("eij,ejk->eik", F, Fpow[d - 1])
        Spow[d] = np.einsum("eij,ejk->eik", F, Spow[d - 1]) + S
    return Fpow, Spow, L


@functools.lru_cache(maxsize=16)
def _noise_tables(key, device: torch.device):
    """f32 transfer matrices P[k, j] = F^{k-1-j} (players, zero for j >= k)
    and the Cholesky factor L, on ``device``."""
    params = SimParams(**dict(key))
    G = params.grid_points
    Fpow, _, L = _affine_tables_np(params)
    Fpow = Fpow.astype(np.float32)
    d = np.arange(G)[:, None] - np.arange(G)[None, :] - 1        # k-1-j
    P = np.where((d >= 0)[:, :, None, None], Fpow[np.clip(d, 0, G), 0],
                 np.float32(0.0))                                 # (G,G,4,4)
    return (torch.from_numpy(P).to(device),
            torch.from_numpy(L.astype(np.float32)).to(device))


def _noise_key(params: SimParams):
    return (("dt", params.dt), ("grid_points", params.grid_points),
            ("tau_player", params.tau_player),
            ("tau_puck", params.tau_puck))


def draw_xi(rng: np.random.Generator, n: int) -> torch.Tensor:
    """(n, 4 players, 4) float32 standard normals from ``rng``."""
    return torch.from_numpy(rng.standard_normal((n, 4, 4),
                                                dtype=np.float32))


def game_rng(seed: int, counter: int) -> np.random.Generator:
    """The Philox stream of one game at one step: keyed by the game's
    seed, with the step counter in the second counter word."""
    return np.random.Generator(np.random.Philox(
        key=seed & 0xFFFFFFFFFFFFFFFF, counter=[0, counter, 0, 0]))


def populate_noise(xi: torch.Tensor, params: SimParams) -> torch.Tensor:
    """Accumulated populate-pass noise from xi (..., G, 4, 4):
    contrib[k] = sum_{j<k} F^{k-1-j} w L xi_j  ->  (..., G, 4, 4)."""
    P, L = _noise_tables(_noise_key(params), xi.device)
    eta = params.noise * torch.einsum("ij,...kej->...kei", L, xi)
    return torch.einsum("kjab,...jeb->...kea", P, eta)


def repropagation_noise(xi: torch.Tensor, params: SimParams) -> torch.Tensor:
    """Per-substep (not accumulated) contributions ``w L xi_j`` from xi
    (..., n, 4, 4), consumed by the exact step's feedback re-propagation.
    Multiple events of one control step that re-propagate an entity over
    the same columns reuse these per-column draws."""
    _, L = _noise_tables(_noise_key(params), xi.device)
    return params.noise * torch.einsum("ij,...kej->...kei", L, xi)
