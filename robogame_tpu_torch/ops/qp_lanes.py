"""Batched dense QP solve on the hand-written CUDA kernel K2.

Counterpart of the JAX package's ``ops/qp_pallas.py::solve_qp_lanes``: the
same problem form and ADMM as :func:`.qp.solve_qp` (its plain version),
over a mandatory leading problem axis.  For CUDA tensors it launches K2
(``csrc/qp_admm.cu`` through ``kernels.qp_admm``) or raises; for CPU
tensors it runs :func:`.qp.solve_qp`.

Shared operands: H (G, n, n) and A (G, m, n) hold G distinct matrices and
problem p of the P = G * group problems reads operand p // group.  The
classical skills' 16 final-time candidates share one H and one A each
across every game (group = games), so the kernel reads 16 matrices where a
broadcast would materialise one per problem; the CBF filter's QPs are all
distinct (group = 1).  g (P, n) and l/u (P, m) are per problem.
"""

from __future__ import annotations

import torch

from .qp import QpSolution, row_scale, solve_qp

MAX_N, MAX_M = 64, 256    # K2's supported shapes: n <= 64, m <= 256


def solve_qp_lanes(H, g, A, l, u, iters: int = 50, n_seg: int = 4,
                   rho: float = 1.0, sigma: float = 1e-6,
                   alpha: float = 1.6, tol: float = 1e-3,
                   scale_rows: bool = False, group: int = 1) -> QpSolution:
    """Solve P QPs min 1/2 x^T H x + g^T x s.t. l <= A x <= u.

    H (P/group, n, n), g (P, n), A (P/group, m, n), l/u (P, m); float32.
    ``scale_rows`` equilibrates A's rows here, before the solve, as the
    JAX wrapper does."""
    P, n = g.shape
    m = A.shape[-2]
    if group < 1 or P % group or H.shape != (P // group, n, n) or \
            A.shape != (P // group, m, n) or l.shape != (P, m) or \
            u.shape != (P, m):
        raise ValueError(
            f"solve_qp_lanes: expected H ({P // max(group, 1)}, {n}, {n}), "
            f"A ({P // max(group, 1)}, m, {n}), l/u ({P}, m) for P={P} "
            f"problems in groups of {group}; got H {tuple(H.shape)}, "
            f"A {tuple(A.shape)}, l {tuple(l.shape)}, u {tuple(u.shape)}")
    f = torch.float32
    H, g, A, l, u = (t.to(f) for t in (H, g, A, l, u))
    if scale_rows:
        A, l, u = row_scale(A, l, u)
    dev = g.device
    if dev.type == "cuda":
        if not MAX_N >= n >= 1 or not MAX_M >= m >= 1:
            raise ValueError(f"K2 supports n <= {MAX_N} variables and "
                             f"m <= {MAX_M} rows, got n={n}, m={m}")
        from .. import kernels
        x, stats = kernels.qp_admm(
            H.contiguous(), g.contiguous(), A.contiguous(), l.contiguous(),
            u.contiguous(), group, n_seg, max(1, iters // n_seg), rho,
            sigma, alpha, tol)
        return QpSolution(x=x, converged=stats[:, 0] > 0.5,
                          prim_res=stats[:, 1], dual_res=stats[:, 2])
    if dev.type != "cpu":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {dev}")
    if group > 1:
        H = H.repeat_interleave(group, dim=0)
        A = A.repeat_interleave(group, dim=0)
    return solve_qp(H, g, A, l, u, iters=iters, rho=rho, sigma=sigma,
                    alpha=alpha, tol=tol, n_seg=n_seg)
