"""Batched dense QP solve on the hand-written CUDA kernel K2.

Counterpart of the JAX package's ``ops/qp_pallas.py::solve_qp_lanes``: the
same problem form and ADMM as :func:`.qp.solve_qp` (its plain version),
over a mandatory leading problem axis.  For CPU tensors it runs
:func:`.qp.solve_qp`; for CUDA tensors it launches K2 on one of two routes
or raises:

* grouped (``csrc/qp_grouped.cu`` through ``kernels.qp_grouped``; plain
  version :func:`solve_qp_grouped_plain`), where :func:`grouped_route`
  holds: one factor setup per shared operand, then the factor-free
  iterations; its problems with an equality row go on to the per-problem
  kernel within the same call;
* per-problem (``csrc/qp_admm.cu`` through ``kernels.qp_admm``), for every
  other call.

Shared operands: H (G, n, n) and A (G, m, n) hold G distinct matrices and
problem p of the P = G * group problems reads operand p // group.  The
classical skills' 16 final-time candidates share one H and one A each
across every game (group = games, the grouped route); the CBF filter's QPs
are all distinct (group = 1, the per-problem route).  g (P, n) and l/u
(P, m) are per problem.
"""

from __future__ import annotations

import torch

from ..plain import plain_version
from .qp import QpSolution, row_scale, solve_qp
from .sqp_lanes import _amax, _mv, _solution

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
        launch = kernels.qp_grouped if grouped_route(n, m, group) else \
            kernels.qp_admm
        x, stats = launch(
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


# ---------------------------------------------------------------------------
# K2's grouped algebra: one factorization per shared operand
# ---------------------------------------------------------------------------
#
# The problems of a group share H and A and differ in g, l, u and their own
# rho.  With no equality row, every row of a problem takes its scalar
# rho_p, so K_p = M0 + rho_p M1 with M0 = H + sigma I and M1 = A'A, both
# the group's, and one generalized eigendecomposition of the pair serves
# every rho:
#
#     K_p^-1 = W diag(1 / (1 + rho_p lam)) W',
#
# from M0 = R R' (positive definite for sigma > 0) and R^-1 M1 R^-T =
# V diag(lam) V', W = R^-T V.  No problem factors anything: an ADMM
# iteration is the products A'w, W'r, W t and A x with a per-problem
# diagonal in the middle.  The factors come once per group in f64 and are
# used in f32.  The grouped kernel (``csrc/qp_grouped.cu``) takes
# n <= GROUPED_MAX_N, m <= GROUPED_MAX_M and groups of at least
# GROUPED_MIN problems; a problem with an equality row (l == u, whose row
# takes 1e3 rho) is outside the algebra and goes to the per-problem
# kernel.

GROUPED_MAX_N, GROUPED_MAX_M = 32, 64
GROUPED_MIN = 32


def grouped_route(n: int, m: int, group: int) -> bool:
    """Whether ``solve_qp_lanes`` takes the grouped kernel at this shape."""
    return group >= GROUPED_MIN and n <= GROUPED_MAX_N and \
        m <= GROUPED_MAX_M


def grouped_factors(H, A, sigma: float):
    """The f64 factors of G shared operands: W (G, n, n) and lam (G, n)
    with (H + sigma I + rho A'A)^-1 = W diag(1 / (1 + rho lam)) W' for
    every rho."""
    Hd, Ad = H.double(), A.double()
    eye = torch.eye(H.shape[-1], dtype=torch.float64, device=H.device)
    R = torch.linalg.cholesky(Hd + sigma * eye)
    Ri = torch.linalg.solve_triangular(R, eye.expand_as(R), upper=False)
    lam, V = torch.linalg.eigh(Ri @ Ad.transpose(-1, -2) @ Ad
                               @ Ri.transpose(-1, -2))
    return Ri.transpose(-1, -2) @ V, lam


@plain_version
def solve_qp_grouped_plain(H, g, A, l, u, group: int, iters: int = 50,
                           n_seg: int = 4, rho: float = 1.0,
                           sigma: float = 1e-6, alpha: float = 1.6,
                           tol: float = 1e-3) -> QpSolution:
    """The plain PyTorch version of K2's grouped route: H (G, n, n),
    A (G, m, n) shared by the ``group`` problems of each group, g (P, n),
    l/u (P, m), P = G * group, rows already scaled.  The factors of
    :func:`grouped_factors` rounded to the working dtype, then the
    factor-free ADMM with :func:`.qp.solve_qp`'s rho adaptation, residuals
    and flags; problems with an equality row are solved by
    :func:`.qp.solve_qp`, as the kernel route hands them to the
    per-problem kernel.  On CUDA tensors TF32 matmuls must be off, as for
    :func:`.qp.solve_qp`."""
    if g.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("solve_qp_grouped_plain needs full-f32 matmuls: "
                           "set torch.backends.cuda.matmul.allow_tf32 = "
                           "False")
    G, n = H.shape[0], H.shape[-1]
    P = g.shape[0]
    dtype = g.dtype
    Wd, lamd = grouped_factors(H, A, sigma)
    W, lam = Wd.to(dtype)[:, None], lamd.to(dtype)[:, None, None]
    Wt = W.transpose(-1, -2)
    Ab, At = A[:, None], A.transpose(-1, -2)[:, None]
    gg, lg, ug = (t.reshape(G, group, 1, -1) for t in (g, l, u))
    sigma_t = torch.full((), sigma, dtype=dtype, device=g.device)
    alpha_t = torch.full((), alpha, dtype=dtype, device=g.device)
    one_m_alpha = 1 - alpha_t
    tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
    rho_s = (torch.clamp(tr / n, 1e-3, 1e6) * rho)[:, None, None, None] \
        .expand(G, group, 1, 1)
    x = torch.zeros_like(gg)
    z = torch.zeros_like(lg)
    y = torch.zeros_like(z)
    seg_iters = max(1, iters // n_seg)
    for _ in range(n_seg):
        d = 1 / (1 + rho_s * lam)
        for _ in range(seg_iters):
            rhs = sigma_t * x - gg + (rho_s * z - y) @ Ab
            x = (d * (rhs @ W)) @ Wt
            Ax = x @ At
            z_t = alpha_t * Ax + one_m_alpha * z
            z_new = torch.minimum(torch.maximum(z_t + y / rho_s, lg), ug)
            y = y + rho_s * (z_t - z_new)
            z = z_new
        Ax = x @ At
        Hx = x @ H.transpose(-1, -2)[:, None]
        Aty = y @ Ab
        prim = _amax(Ax - z)
        dual = _amax(Hx + gg + Aty)
        p_sc = torch.maximum(_amax(Ax), _amax(z)) + 1e-9
        d_sc = torch.maximum(torch.maximum(_amax(Hx), _amax(Aty)),
                             _amax(gg)) + 1e-9
        ratio = torch.sqrt((prim / p_sc) / (dual / d_sc + 1e-12))
        rho_s = torch.clamp(rho_s * torch.clamp(ratio, 0.2, 5.0)[..., None],
                            1e-6, 1e8)
    conv = (prim < tol * p_sc) & (dual < 10.0 * tol * d_sc)
    sol = QpSolution(x=x.reshape(P, n), converged=conv.reshape(P),
                     prim_res=prim.reshape(P), dual_res=dual.reshape(P))
    eq = (l == u).any(-1)
    if bool(eq.any()):
        idx = eq.nonzero()[:, 0]
        per = solve_qp(H[idx // group], g[idx], A[idx // group], l[idx],
                       u[idx], iters=iters, rho=rho, sigma=sigma,
                       alpha=alpha, tol=tol, n_seg=n_seg)
        for full, part in zip(sol, per):
            full[idx] = part
    return sol


# ---------------------------------------------------------------------------
# The structured two-agent QP on the hand-written CUDA kernel K5
# ---------------------------------------------------------------------------
#
# Counterpart of the JAX package's ``ops/qp_pallas.py::solve_qp_lanes_joint``
# (the CMPC shape): per-player column blocks, the input box as implicit
# rows, a block-Schur solve.  For CUDA tensors it launches K5
# (``csrc/qp_joint.cu`` through ``kernels.qp_joint``) or raises; for CPU
# tensors it runs the plain version below, which follows the kernel's
# arithmetic: per segment the factors of
#
#     K = [[K11, K12], [K12', K22]],  Kpp = Hp + (sigma + rho) I + Ap' Rp Ap,
#     K12 = P1' Rpair P2 (the pair rows' blocks),
#
# as C1 = chol(K11)^-1, W = C1 K12, Cs = chol(K22 - W'W)^-1 and B21 =
# -Cs W'C1, so that L^-1 = [[C1, 0], [B21, Cs]] inverts K's Cholesky factor,
# and each ADMM iteration solves K x = r as t = L^-1 r, x = L^-T t
# (:func:`linv_factors`, :func:`linv_solve`).  K4's plain version runs the
# same segment with the six products of its kernel (:func:`schur_solve`).

# K5's and K4's supported sizes: n1 % 8 == 0 (JAX's own limit), n1 <= 64
# variables a player and at most 512 constraint rows (2 m_own + m_pair)
MAX_N1_JOINT, MAX_ROWS_JOINT = 64, 512


def _joint_check(name, Hb, g, Ab, l, u, lx, ux, m_own, m_pair):
    B = g.shape[0]
    n1 = Hb.shape[-1]
    if n1 % 8 != 0:
        raise ValueError(f"{name}: joint kernel requires n1 % 8 == 0, got "
                         f"{n1}")
    R = 2 * m_own + m_pair
    want = {"Hb": (B, 2, n1, n1), "g": (B, 2 * n1),
            "Ab": (B, 2, m_own + m_pair, n1), "l": (B, R), "u": (B, R),
            "lx": (B, 2 * n1), "ux": (B, 2 * n1)}
    got = {"Hb": Hb, "g": g, "Ab": Ab, "l": l, "u": u, "lx": lx, "ux": ux}
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got "
                             f"{tuple(got[key].shape)}")


def joint_row_scale(Ab, l, u, m_own: int):
    """Row equilibration by the full joint-row norm (a pair row spans both
    players' blocks), as the JAX wrapper does before its kernel; the box
    rows have unit norm and stay unscaled.  Returns the scaled (Ab, l, u)."""
    B = Ab.shape[0]
    m_pair = Ab.shape[2] - m_own
    own = Ab[:, :, :m_own]
    d_own = 1.0 / torch.clamp(torch.sqrt((own * own).sum(-1)), min=1e-8)
    pair = Ab[:, :, m_own:]
    d_pair = 1.0 / torch.clamp(torch.sqrt((pair * pair).sum((-1, -3))),
                               min=1e-8)
    d_ab = torch.cat([d_own, d_pair[:, None].expand(B, 2, m_pair)], dim=2)
    d_rows = torch.cat([d_own[:, 0], d_own[:, 1], d_pair], dim=1)
    return Ab * d_ab[..., None], l * d_rows, u * d_rows


def joint_qp_stats(Hb, g, Ab, l, u, lx, ux, *, m_own: int, m_pair: int,
                   iters: int = 50, n_seg: int = 4, rho: float = 1.0,
                   sigma: float = 1e-6, alpha: float = 1.6,
                   tol: float = 1e-3, scale_rows: bool = False):
    """The structured joint QP solve by device: K5 on CUDA tensors, the
    plain version on CPU tensors.  Returns x (B, 2 n1) and stats (B, 5) =
    [converged, prim_res, dual_res, p_sc, d_sc] of the last segment."""
    _joint_check("solve_qp_lanes_joint", Hb, g, Ab, l, u, lx, ux, m_own,
                 m_pair)
    f = torch.float32
    Hb, g, Ab, l, u, lx, ux = (t.to(f) for t in (Hb, g, Ab, l, u, lx, ux))
    if scale_rows:
        Ab, l, u = joint_row_scale(Ab, l, u, m_own)
    args = [t.contiguous() for t in (Hb, g, Ab, l, u, lx, ux)]
    kw = dict(m_own=m_own, m_pair=m_pair, n_seg=n_seg,
              seg_iters=max(1, iters // n_seg), rho=rho, sigma=sigma,
              alpha=alpha, tol=tol)
    dev = g.device
    if dev.type == "cuda":
        n1 = Hb.shape[-1]
        if n1 > MAX_N1_JOINT or 2 * m_own + m_pair > MAX_ROWS_JOINT:
            raise ValueError(f"K5 supports n1 <= {MAX_N1_JOINT} and at most "
                             f"{MAX_ROWS_JOINT} rows, got n1={n1}, "
                             f"{2 * m_own + m_pair} rows")
        from .. import kernels
        return kernels.qp_joint(*args, **kw)
    if dev.type != "cpu":
        raise ValueError(f"K5 runs on cuda or cpu tensors, not {dev}")
    return joint_plain_stats(*args, **kw)


def solve_qp_lanes_joint(Hb, g, Ab, l, u, lx, ux, **kw) -> QpSolution:
    """Two-agent joint QP over B problems (the CMPC shape):

        min 1/2 x'Hx + g'x  s.t.  lx <= x <= ux,  l <= A x <= u

    with H = blockdiag(Hb[:, 0], Hb[:, 1]) (B, 2, n1, n1), g (B, 2 n1),
    Ab (B, 2, m_own + m_pair, n1) player p's columns of its own rows then
    of the m_pair shared rows (pair row r is [Ab[:, 0, m_own + r],
    Ab[:, 1, m_own + r]]), l/u (B, 2 m_own + m_pair) ordered [own 1, own 2,
    pair], lx/ux (B, 2 n1).  K5 on CUDA tensors, the plain version on CPU
    tensors.  Keyword arguments as :func:`joint_qp_stats` (``m_own`` and
    ``m_pair`` required)."""
    return _solution(*joint_qp_stats(Hb, g, Ab, l, u, lx, ux, **kw))


def solve_qp_lanes_joint_plain(Hb, g, Ab, l, u, lx, ux, *, m_own: int,
                               m_pair: int, iters: int = 50, n_seg: int = 4,
                               rho: float = 1.0, sigma: float = 1e-6,
                               alpha: float = 1.6, tol: float = 1e-3,
                               scale_rows: bool = False) -> QpSolution:
    """K5's plain PyTorch version on the tensors' own device and dtype (the
    card only to compare with the kernel)."""
    _joint_check("solve_qp_lanes_joint_plain", Hb, g, Ab, l, u, lx, ux,
                 m_own, m_pair)
    if scale_rows:
        Ab, l, u = joint_row_scale(Ab, l, u, m_own)
    return _solution(*joint_plain_stats(
        Hb, g, Ab, l, u, lx, ux, m_own=m_own, m_pair=m_pair, n_seg=n_seg,
        seg_iters=max(1, iters // n_seg), rho=rho, sigma=sigma, alpha=alpha,
        tol=tol))


def joint_ax(A, x, m_own: int):
    """A x for the blocks A (B, 2, m1, n1) at x (B, 2 n1): rows [own 1 (m_own),
    own 2 (m_own), pair (m_pair)]; a pair row sums both players' parts."""
    n1 = A.shape[-1]
    f = _mv(A, x.reshape(-1, 2, n1))                       # (B, 2, m1)
    return torch.cat([f[:, 0, :m_own], f[:, 1, :m_own],
                      f[:, 0, m_own:] + f[:, 1, m_own:]], dim=1)


def joint_atw(A, w, m_own: int):
    """A'w (B, 2 n1) for a row vector w (B, 2 m_own + m_pair)."""
    wf = torch.stack([torch.cat([w[:, :m_own], w[:, 2 * m_own:]], 1),
                      torch.cat([w[:, m_own:2 * m_own], w[:, 2 * m_own:]], 1)],
                     dim=1)                                # (B, 2, m1)
    return _mv(A.transpose(-1, -2), wf).flatten(1)


def _tri_inv(K):
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.linalg.solve_triangular(torch.linalg.cholesky(K),
                                         eye.expand_as(K), upper=False)


def schur_factors(Hb, A, ro, rho_s, sigma_t, m_own: int):
    """The block-Schur factors (C1, W, Cs) of K for the blocks A, row
    penalties ro (B, R) and the box rows' rho_s (B,)."""
    n1 = A.shape[-1]
    eye = torch.eye(n1, dtype=A.dtype, device=A.device)
    rp = ro[:, 2 * m_own:]
    r1 = torch.cat([ro[:, :m_own], rp], dim=1)
    r2 = torch.cat([ro[:, m_own:2 * m_own], rp], dim=1)
    A1, A2 = A[:, 0], A[:, 1]
    diag = (sigma_t + rho_s)[:, None, None] * eye
    K11 = (A1.transpose(-1, -2) * r1[:, None, :]) @ A1 + Hb[:, 0] + diag
    C1 = _tri_inv(K11)
    K12 = (A1[:, m_own:].transpose(-1, -2) * rp[:, None, :]) @ A2[:, m_own:]
    W = C1 @ K12
    K22 = (A2.transpose(-1, -2) * r2[:, None, :]) @ A2 + Hb[:, 1] + diag
    Cs = _tri_inv(K22 - W.transpose(-1, -2) @ W)
    return C1, W, Cs


def schur_solve(C1, W, Cs, r):
    """x = K^-1 r through the factors of :func:`schur_factors`."""
    n1 = C1.shape[-1]
    Wt = W.transpose(-1, -2)
    t1 = _mv(C1, r[:, :n1])
    t2 = r[:, n1:] - _mv(Wt, t1)
    x2 = _mv(Cs.transpose(-1, -2), _mv(Cs, t2))
    x1 = _mv(C1.transpose(-1, -2), t1 - _mv(W, x2))
    return torch.cat([x1, x2], dim=1)


def linv_factors(Hb, A, ro, rho_s, sigma_t, m_own: int):
    """L^-1 = [[C1, 0], [B21, Cs]] (B, 2 n1, 2 n1), L the Cholesky factor
    of K: the blocks of :func:`schur_factors` and B21 = -Cs W'C1."""
    C1, W, Cs = schur_factors(Hb, A, ro, rho_s, sigma_t, m_own)
    B21 = -(Cs @ (W.transpose(-1, -2) @ C1))
    return (torch.cat([torch.cat([C1, torch.zeros_like(C1)], 2),
                       torch.cat([B21, Cs], 2)], 1),)


def linv_solve(Li, r):
    """x = K^-1 r = L^-T (L^-1 r) for L^-1 from :func:`linv_factors`."""
    return _mv(Li.transpose(-1, -2), _mv(Li, r))


def joint_segment(c, Hb, g, A, lo, hi, lx, ux, is_eq, iters: int,
                  m_own: int, sigma_t, alpha_t, solver):
    """One adaptive-rho segment of the structured ADMM from the carry
    c = (x, zx, z, yx, y, rho_s): factor, ``iters`` iterations, residuals,
    the rho update.  Rows with ``is_eq`` take 1e3 rho (None: no equality
    rows).  ``solver`` is (factors, solve): K5's (:func:`linv_factors`,
    :func:`linv_solve`) or K4's (:func:`schur_factors`,
    :func:`schur_solve`).  Returns (carry, (prim, dual, p_sc, d_sc))."""
    x, zx, z, yx, y, rho_s = c
    r = rho_s[:, None]
    ro = r.expand_as(z) if is_eq is None else torch.where(is_eq, 1e3 * r, r)
    one_m_alpha = 1 - alpha_t
    factors, solve = solver
    F = factors(Hb, A, ro, rho_s, sigma_t, m_own)
    for _ in range(iters):
        rhs = sigma_t * x - g + joint_atw(A, ro * z - y, m_own) + \
            (r * zx - yx)
        x = solve(*F, rhs)
        ax = joint_ax(A, x, m_own)
        zx_t = alpha_t * x + one_m_alpha * zx
        zx_n = torch.minimum(torch.maximum(zx_t + yx / r, lx), ux)
        yx = yx + r * (zx_t - zx_n)
        zx = zx_n
        z_t = alpha_t * ax + one_m_alpha * z
        z_n = torch.minimum(torch.maximum(z_t + y / ro, lo), hi)
        y = y + ro * (z_t - z_n)
        z = z_n
    n1 = A.shape[-1]
    ax = joint_ax(A, x, m_own)
    Hx = _mv(Hb, x.reshape(-1, 2, n1)).flatten(1)
    Aty = joint_atw(A, y, m_own) + yx
    prim = _amax(x - zx, ax - z)
    dual = _amax(Hx + g + Aty)
    p_sc = torch.maximum(_amax(x, ax), _amax(zx, z)) + 1e-9
    d_sc = torch.maximum(_amax(Hx, Aty), _amax(g)) + 1e-9
    ratio = torch.sqrt((prim / p_sc) / (dual / d_sc + 1e-12))
    rho_s = torch.clamp(rho_s * torch.clamp(ratio, 0.2, 5.0), 1e-6, 1e8)
    return (x, zx, z, yx, y, rho_s), (prim, dual, p_sc, d_sc)


def joint_rho0(Hb, rho: float):
    """rho0 = clip(tr(H) / n, 1e-3, 1e6) rho over both blocks."""
    n2 = 2 * Hb.shape[-1]
    tr = Hb.diagonal(dim1=-2, dim2=-1).sum((-1, -2))
    return torch.clamp(tr * (1.0 / n2), 1e-3, 1e6) * rho


def joint_stats(res, tol: float):
    prim, dual, p_sc, d_sc = res
    conv = (prim < tol * p_sc) & (dual < 10.0 * tol * d_sc)
    return torch.stack([conv.to(prim.dtype), prim, dual, p_sc, d_sc], dim=1)


@plain_version
def joint_plain_stats(Hb, g, Ab, l, u, lx, ux, *, m_own: int, m_pair: int,
                      n_seg: int, seg_iters: int, rho: float, sigma: float,
                      alpha: float, tol: float):
    """K5's plain version on rows already scaled: ``n_seg`` cold segments
    of ``seg_iters`` iterations.  Returns x (B, 2 n1) and stats (B, 5)."""
    if Hb.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("solve_qp_lanes_joint_plain needs full-f32 "
                           "matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    dtype, dev = g.dtype, g.device
    sigma_t = torch.full((), sigma, dtype=dtype, device=dev)
    alpha_t = torch.full((), alpha, dtype=dtype, device=dev)
    zv = torch.zeros_like(g)
    zr = torch.zeros_like(l)
    c = (zv, zv, zr, zv, zr, joint_rho0(Hb, rho))
    res = None
    for _ in range(n_seg):
        c, res = joint_segment(c, Hb, g, Ab, l, u, lx, ux, l == u,
                               seg_iters, m_own, sigma_t, alpha_t,
                               (linv_factors, linv_solve))
    return c[0], joint_stats(res, tol)
