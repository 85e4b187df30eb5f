"""Discrete-time models of the damped double integrator and their condensed
(prediction-matrix) horizon forms.

The controllers share the player model ``pdot = v, vdot = (u - v)/tau``:
:func:`euler_ab` is its forward-Euler discretization (the reference
controllers' model), :func:`exact_ab` its exact zero-order-hold map.

Condensed form over a horizon of N steps:
    X = Phi x0 + Gamma U,   X = [x_1..x_N],  U = [u_0..u_{N-1}]

Tensors are built on the CPU unless ``h`` is a tensor elsewhere; the
trajectory optimizer builds its tables once and moves them to the device.
"""

from __future__ import annotations

import torch


def euler_ab(dt, tau, dtype=torch.float32):
    """Forward-Euler model: A = I + dt Ac, B = dt Bc."""
    dt = torch.as_tensor(dt, dtype=dtype)
    a = torch.eye(4, dtype=dtype)
    a[0, 2] = dt
    a[1, 3] = dt
    a[2, 2] += -dt / tau
    a[3, 3] += -dt / tau
    b = torch.zeros((4, 2), dtype=dtype)
    b[2, 0] = dt / tau
    b[3, 1] = dt / tau
    return a, b


def exact_ab(h, tau, dtype=torch.float32):
    """Exact ZOH discretization of pdot=v, vdot=(u-v)/tau.

    v' = u + (v-u) e,  p' = p + tau (v-u)(1-e) + u h,  e = exp(-h/tau).
    ``h`` may be a tensor of step sizes: A (..., 4, 4), B (..., 4, 2).
    """
    h = torch.as_tensor(h, dtype=dtype)
    e = torch.exp(-h / tau)
    s = tau * (1.0 - e)          # integral of e^{-t/tau} over [0, h]
    a = torch.eye(4, dtype=dtype, device=h.device).expand(
        h.shape + (4, 4)).clone()
    a[..., 0, 2] = s
    a[..., 1, 3] = s
    a[..., 2, 2] = e
    a[..., 3, 3] = e
    b = torch.zeros(h.shape + (4, 2), dtype=dtype, device=h.device)
    b[..., 0, 0] = h - s
    b[..., 1, 1] = h - s
    b[..., 2, 0] = 1.0 - e
    b[..., 3, 1] = 1.0 - e
    return a, b


def exact_puck_ab(h, tau, drag=1.0, dtype=torch.float32):
    """Exact free-flight puck map (no input): v' = v e^{-kh},
    p' = p + v (1-e^{-kh})/k, k = drag/tau.  ``drag=1`` is the controllers'
    puck model; the simulator itself uses drag=0.2."""
    h = torch.as_tensor(h, dtype=dtype)
    k = drag / tau
    e = torch.exp(-k * h)
    s = (1.0 - e) / k
    a = torch.eye(4, dtype=dtype, device=h.device)
    a[0, 2] = s
    a[1, 3] = s
    a[2, 2] = e
    a[3, 3] = e
    return a


def prediction_matrices(A, B, N: int):
    """Phi: (..., N, nx, nx) with Phi[k] = A^{k+1};
    Gamma: (..., N, N, nx, nu) with Gamma[k, j] = A^{k-j} B for j <= k
    else 0, for models A (..., nx, nx), B (..., nx, nu).

    X_k (k=1..N) = Phi[k-1] x0 + sum_j Gamma[k-1, j] u_j.  The powers are
    a loop of full-f32 matrix products."""
    nx = B.shape[-2]
    batch = A.shape[:-2]
    eye = torch.eye(nx, dtype=A.dtype, device=A.device).expand(
        batch + (nx, nx))
    Ak = eye
    powers = []
    for _ in range(N):
        Ak = A @ Ak
        powers.append(Ak)
    powers = torch.stack(powers, dim=-3)         # powers[k] = A^{k+1}
    eyeA = torch.cat([eye[..., None, :, :], powers[..., :-1, :, :]],
                     dim=-3)                     # A^0 .. A^{N-1}
    idx = torch.arange(N, device=A.device)
    diff = idx[:, None] - idx[None, :]           # (N, N)
    safe = diff.clamp(0, N - 1)
    # one model: the (N, N, nx, nx) @ (nx, nu) product the trajectory
    # tables were built with (a broadcast B rounds differently)
    Bk = B if B.dim() == 2 else B[..., None, None, :, :]
    gam = eyeA[..., safe, :, :] @ Bk             # (..., N, N, nx, nu)
    gam = torch.where((diff >= 0)[:, :, None, None], gam,
                      torch.zeros((), dtype=A.dtype, device=A.device))
    return powers, gam


def condense(A, B, N: int):
    """Flat condensed matrices: X (N*nx) = Phi_f (N*nx, nx) x0 +
    Gamma_f (N*nx, N*nu) U, with the models' leading axes in front."""
    nx, nu = B.shape[-2:]
    batch = A.shape[:-2]
    powers, gam = prediction_matrices(A, B, N)
    phi_f = powers.reshape(batch + (N * nx, nx))
    gam_f = gam.transpose(-3, -2).reshape(batch + (N * nx, N * nu))
    return phi_f, gam_f
