"""Batched convex QP solver (OSQP-style ADMM, fixed iteration count), in
plain PyTorch.

This is the plain version of the hand-written CUDA kernel K2
(``csrc/qp_admm.cu``): :func:`..ops.qp_lanes.solve_qp_lanes` runs it for
CPU tensors, and on the card it serves only as the kernel's yardstick.
It follows the JAX package's ``ops/qp.py::_solve_qp_inner`` step for
step, batched over a leading problem axis:

* rho0 = clip(tr(H)/n, 1e-3, 1e6) * rho;
* ``n_seg`` segments of ``iters // n_seg`` iterations; each segment forms
  K = H + sigma I + A^T diag(rho) A, factors it (Cholesky) and inverts it
  explicitly, so an iteration is matrix-vector products only;
* equality rows (l == u) at 1e3 rho, over-relaxation alpha;
* rho adapts between segments from the residual ratio;
* convergence: prim < tol * p_sc and dual < 10 tol * d_sc, from the last
  segment's residuals.

Problem form:   min 1/2 x^T H x + g^T x   s.t.  l <= A x <= u

Beside the kernels' yardstick, :func:`solve_qp` is the port's counterpart
of JAX's ``solve_qp`` wherever JAX calls that plain XLA ADMM directly:
the fixed-final-time and obstacle planners of ``control/trajopt.py`` and
``control/obstacles.py`` run it on the caller's device and dtype.
:func:`solve_box_ls` is JAX's box-constrained least squares.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..plain import plain_version


class QpSolution(NamedTuple):
    x: torch.Tensor           # (P, n) primal solution
    converged: torch.Tensor   # (P,) bool
    prim_res: torch.Tensor    # (P,) final primal residual (inf-norm)
    dual_res: torch.Tensor    # (P,) final dual residual (inf-norm)


def row_scale(A, l, u):
    """OSQP-style row equilibration: unit-norm constraint rows.  A is
    (G, m, n) and l/u (P, m) with P a multiple of G (problem p uses
    operand p // (P/G)); returns the scaled (A, l, u)."""
    rn = torch.sqrt((A * A).sum(-1))
    d = 1.0 / torch.clamp(rn, min=1e-8)
    dp = d.repeat_interleave(l.shape[0] // A.shape[0], dim=0)
    return A * d[..., None], l * dp, u * dp


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _amax(v):
    return v.abs().amax(dim=-1)


@plain_version
def solve_qp(H, g, A, l, u, iters: int = 50, rho: float = 1.0,
             sigma: float = 1e-6, alpha: float = 1.6, tol: float = 1e-3,
             scale_rows: bool = False, n_seg: int = 4) -> QpSolution:
    """ADMM with over-relaxation over a leading batch axis: H (P, n, n),
    g (P, n), A (P, m, n), l/u (P, m).  Equality rows (l == u) get a 1000x
    larger rho; ``scale_rows`` equilibrates the constraint rows first.

    On CUDA tensors the matrix products must run in full f32 (TF32 is
    too coarse for the residual tests), so TF32 must be off."""
    if H.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("solve_qp needs full-f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    n = H.shape[-1]
    dtype = H.dtype
    if scale_rows:
        A, l, u = row_scale(A, l, u)
    is_eq = l == u
    eye = torch.eye(n, dtype=dtype, device=H.device)
    At = A.transpose(-1, -2)
    sigma_t = torch.full((), sigma, dtype=dtype, device=H.device)
    alpha_t = torch.full((), alpha, dtype=dtype, device=H.device)
    one_m_alpha = 1 - alpha_t

    tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
    rho_s = torch.clamp(tr / n, 1e-3, 1e6) * rho               # (P,)

    x = torch.zeros(g.shape, dtype=dtype, device=H.device)
    z = torch.zeros(l.shape, dtype=dtype, device=H.device)
    y = torch.zeros_like(z)
    seg_iters = max(1, iters // n_seg)
    prim = dual = p_sc = d_sc = None
    for _ in range(n_seg):
        rho_vec = torch.where(is_eq, 1e3 * rho_s[:, None], rho_s[:, None])
        K = H + sigma_t * eye + (At * rho_vec[:, None, :]) @ A
        chol = torch.linalg.cholesky(K)
        t = torch.linalg.solve_triangular(chol, eye.expand_as(K),
                                          upper=False)
        Kinv = torch.linalg.solve_triangular(chol.transpose(-1, -2), t,
                                             upper=True)
        for _ in range(seg_iters):
            rhs = sigma_t * x - g + _mv(At, rho_vec * z - y)
            x = _mv(Kinv, rhs)
            Ax = _mv(A, x)
            z_t = alpha_t * Ax + one_m_alpha * z
            z_new = torch.minimum(torch.maximum(z_t + y / rho_vec, l), u)
            y = y + rho_vec * (z_t - z_new)
            z = z_new
        # adaptive rho (OSQP section 5.2): balance the residual ratio
        Ax = _mv(A, x)
        Hx = _mv(H, x)
        Aty = _mv(At, y)
        prim = _amax(Ax - z)
        dual = _amax(Hx + g + Aty)
        p_sc = torch.maximum(_amax(Ax), _amax(z)) + 1e-9
        d_sc = torch.maximum(torch.maximum(_amax(Hx), _amax(Aty)),
                             _amax(g)) + 1e-9
        ratio = torch.sqrt((prim / p_sc) / (dual / d_sc + 1e-12))
        rho_s = torch.clamp(rho_s * torch.clamp(ratio, 0.2, 5.0), 1e-6, 1e8)
    conv = (prim < tol * p_sc) & (dual < 10.0 * tol * d_sc)
    return QpSolution(x=x, converged=conv, prim_res=prim, dual_res=dual)


def solve_qp_batch(H, g, A, l, u, iters: int = 50, **kw) -> QpSolution:
    """:func:`solve_qp` over the leading batch axis of every argument (the
    JAX package's name for its ``vmap``; :func:`solve_qp` is batched
    already)."""
    return solve_qp(H, g, A, l, u, iters=iters, **kw)


@plain_version
def solve_box_ls(F, b, lo, hi, iters: int = 40, reg: float = 1e-8):
    """Box-constrained least squares  min ||F x - b||^2  s.t. lo <= x <= hi
    by projected gradient with the fixed step 1 / ||F^T F + reg I||_2,
    over any leading batch axes: F (..., m, n), b (..., m), lo/hi
    broadcastable to (..., n).  For condensed trajectory problems whose
    only constraints are input boxes (the JAX package's
    ``ops/qp.py::solve_box_ls``)."""
    n = F.shape[-1]
    Ft = F.transpose(-1, -2)
    H = Ft @ F + reg * torch.eye(n, dtype=F.dtype, device=F.device)
    g = -_mv(Ft, b)
    step = 1.0 / torch.linalg.matrix_norm(H, ord=2)[..., None]
    x = torch.zeros(g.shape, dtype=F.dtype, device=F.device)
    x = torch.minimum(torch.maximum(x, lo), hi)
    for _ in range(iters):
        x = torch.minimum(torch.maximum(x - step * (_mv(H, x) + g), lo), hi)
    return x
