"""Fused single-agent DMPC SQP solve on the hand-written CUDA kernel K3.

Counterpart of the JAX package's ``ops/sqp_pallas.py::solve_dmpc_sqp_lanes``:
the whole SQP loop of one DMPC candidate (keepout relinearization, row
scaling, ADMM warm-carried across SQP iterations) in one launch over a
leading problem axis.  For CUDA tensors it launches K3
(``csrc/dmpc_sqp.cu`` through ``kernels.dmpc_sqp``) or raises; for CPU
tensors it runs :func:`solve_dmpc_sqp_plain`, the plain PyTorch version,
which follows the kernel's algorithm step by step:

* once per solve: the per-knot gram terms gxx, gxy, gyy of the position
  sensitivities ``sg`` (the closed-form row norms of every arena and
  keepout row) and rho0 = clip(tr(H) / n1, 1e-3, 1e6) * rho;
* relinearization at x: the 3N keepout rows 2 (dx sgx + dy sgy) and their
  bounds, every own row scaled by d = 1 / max(norm, 1e-8) (the keepout
  rows' upper bound 1e9 d);
* the input box rows are implicit, unscaled, at the same scalar rho;
* SQP iteration 1 runs ``n_seg0`` cold segments of ``it0`` iterations;
  each segment forms K = H + (sigma + rho) I + rho A^T A, factors and
  inverts it, runs alpha-over-relaxed ADMM, then the residuals and
  rho <- clip(rho clip(ratio, 0.2, 5), 1e-6, 1e8);
* each later iteration relinearizes at x, rescales the row duals by
  d_old / d_new, reseeds z = A_new x and runs one ``it_rest`` segment
  with the carried rho;
* convergence from the last segment: prim < tol p_sc and
  dual < 10 tol d_sc.

Layouts are the JAX wrapper's, batch-leading: H (B, n1, n1), g (B, n1),
sg (B, N, 2, n1), p0 (B, N, 2), obs (B, n_obs, 2), lo/hi_arena (B, 2N)
ordered [x rows (N); y rows (N)], lx/ux/U0 (B, n1), with n1 = 2N.
"""

from __future__ import annotations

import torch

from .qp import QpSolution

# K3's supported sizes: n1 = 2N with n1 % 8 == 0 and n1 <= 64, and at most
# 256 own rows (2N arena rows + n_obs N keepout rows)
MAX_N1, MAX_ROWS = 64, 256


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _amax(*vs):
    return torch.stack([v.abs().amax(dim=-1) for v in vs]).amax(dim=0)


def _check(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, N, n_obs):
    B, n1 = g.shape
    want = {"H": (B, n1, n1), "sg": (B, N, 2, n1), "p0": (B, N, 2),
            "obs": (B, n_obs, 2), "lo_arena": (B, 2 * N),
            "hi_arena": (B, 2 * N), "lx": (B, n1), "ux": (B, n1),
            "U0": (B, n1)}
    got = {"H": H, "sg": sg, "p0": p0, "obs": obs, "lo_arena": lo_arena,
           "hi_arena": hi_arena, "lx": lx, "ux": ux, "U0": U0}
    if n1 != 2 * N:
        raise ValueError(f"solve_dmpc_sqp: need n1 == 2N, got n1={n1}, N={N}")
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"solve_dmpc_sqp: {name} must be {shape}, got "
                             f"{tuple(got[name].shape)}")


def dmpc_sqp_stats(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, *,
                   N: int, n_obs: int, n_seg0: int = 4, it0: int = 37,
                   sqp_rest: int = 5, it_rest: int = 40, rho: float = 1.0,
                   sigma: float = 1e-6, alpha: float = 1.6, tol: float = 1e-3,
                   d2: float = 0.16):
    """The fused SQP solve by device: K3 on CUDA tensors, the plain version
    on CPU tensors.  Returns x (B, n1) and stats (B, 5) = [converged,
    prim_res, dual_res, p_sc, d_sc] of the last segment."""
    _check(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, N, n_obs)
    f = torch.float32
    args = [t.to(f).contiguous() for t in (H, g, sg, p0, obs, lo_arena,
                                          hi_arena, lx, ux, U0)]
    kw = dict(N=N, n_obs=n_obs, n_seg0=n_seg0, it0=it0, sqp_rest=sqp_rest,
              it_rest=it_rest, rho=rho, sigma=sigma, alpha=alpha, tol=tol,
              d2=d2)
    dev = g.device
    if dev.type == "cuda":
        n1, m_own = 2 * N, (2 + n_obs) * N
        if n1 % 8 or not 8 <= n1 <= MAX_N1 or m_own > MAX_ROWS:
            raise ValueError(f"K3 supports n1 = 2N with n1 % 8 == 0, "
                             f"n1 <= {MAX_N1} and at most {MAX_ROWS} rows, "
                             f"got n1={n1}, {m_own} rows")
        from .. import kernels
        return kernels.dmpc_sqp(*args, **kw)
    if dev.type != "cpu":
        raise ValueError(f"K3 runs on cuda or cpu tensors, not {dev}")
    return _plain_stats(*args, **kw)


def flag_margin(stats, tol: float = 1e-3):
    """max(prim / (tol p_sc), dual / (10 tol d_sc)) per problem from the
    stats of :func:`dmpc_sqp_stats`: below 1 where the solve converged;
    near 1 the flag may flip under f32 roundoff."""
    return torch.maximum(stats[:, 1] / (tol * stats[:, 3]),
                         stats[:, 2] / (10.0 * tol * stats[:, 4]))


def _solution(x, stats) -> QpSolution:
    return QpSolution(x=x, converged=stats[:, 0] > 0.5, prim_res=stats[:, 1],
                      dual_res=stats[:, 2])


def solve_dmpc_sqp_lanes(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0,
                         **kw) -> QpSolution:
    """Fused SQP single-agent solve over B problems (the DMPC shape): K3 on
    CUDA tensors, :func:`solve_dmpc_sqp_plain` on CPU tensors.  Keyword
    arguments as :func:`dmpc_sqp_stats` (``N`` and ``n_obs`` required)."""
    return _solution(*dmpc_sqp_stats(H, g, sg, p0, obs, lo_arena, hi_arena,
                                     lx, ux, U0, **kw))


def solve_dmpc_sqp_plain(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0,
                         **kw) -> QpSolution:
    """K3's plain PyTorch version on the tensors' own device (the card only
    to compare with the kernel).  Keyword arguments as
    :func:`dmpc_sqp_stats`."""
    _check(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, kw["N"],
           kw["n_obs"])
    return _solution(*_plain_stats(H, g, sg, p0, obs, lo_arena, hi_arena,
                                   lx, ux, U0, **kw))


def _plain_stats(H, g, sg, p0, obs, lo_arena, hi_arena, lx, ux, U0, *,
                 N: int, n_obs: int, n_seg0: int = 4, it0: int = 37,
                 sqp_rest: int = 5, it_rest: int = 40, rho: float = 1.0,
                 sigma: float = 1e-6, alpha: float = 1.6, tol: float = 1e-3,
                 d2: float = 0.16):
    if H.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("solve_dmpc_sqp_plain needs full-f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    B, n1 = g.shape
    dtype, dev = g.dtype, g.device
    eye = torch.eye(n1, dtype=dtype, device=dev)
    sigma_t = torch.full((), sigma, dtype=dtype, device=dev)
    alpha_t = torch.full((), alpha, dtype=dtype, device=dev)
    one_m_alpha = 1 - alpha_t
    sgx, sgy = sg[:, :, 0, :], sg[:, :, 1, :]                 # (B, N, n1)
    gxx = (sgx * sgx).sum(-1)
    gxy = (sgx * sgy).sum(-1)
    gyy = (sgy * sgy).sum(-1)
    arena_norm = torch.cat([torch.sqrt(gxx), torch.sqrt(gyy)], dim=1)
    tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
    rho_s = torch.clamp(tr * (1.0 / n1), 1e-3, 1e6) * rho        # (B,)
    p0x, p0y = p0[..., 0], p0[..., 1]                            # (B, N)
    ox, oy = obs[..., 0:1], obs[..., 1:2]                        # (B, M, 1)
    big = torch.full((B, n_obs * N), 1e9, dtype=dtype, device=dev)

    def relinearize(x):
        """The scaled own rows at x: A (B, m_own, n1), lo, hi, d."""
        accx = p0x + _mv(sgx, x)
        accy = p0y + _mv(sgy, x)
        dx = accx[:, None] - ox                                  # (B, M, N)
        dy = accy[:, None] - oy
        ko_norm = 2.0 * torch.sqrt(dx * dx * gxx[:, None]
                                   + 2.0 * dx * dy * gxy[:, None]
                                   + dy * dy * gyy[:, None])
        gval = dx * dx + dy * dy - d2
        rhs = (2.0 * (dx * accx[:, None] + dy * accy[:, None]) - gval
               - 2.0 * (dx * p0x[:, None] + dy * p0y[:, None]))
        norm = torch.cat([arena_norm, ko_norm.reshape(B, -1)], dim=1)
        d = 1.0 / torch.clamp(norm, min=1e-8)
        lo = torch.cat([lo_arena, rhs.reshape(B, -1)], dim=1) * d
        hi = torch.cat([hi_arena, big], dim=1) * d
        ko = 2.0 * (dx[..., None] * sgx[:, None] + dy[..., None] * sgy[:, None])
        A = torch.cat([sgx, sgy, ko.reshape(B, -1, n1)], dim=1) * d[..., None]
        return A, lo, hi, d

    def segment(c, A, lo, hi, iters):
        x, zx, zo, yx, yo, rho_s = c
        r = rho_s[:, None]
        At = A.transpose(-1, -2)
        K = H + r[..., None] * (At @ A) + (sigma_t + rho_s)[:, None, None] * eye
        chol = torch.linalg.cholesky(K)
        C = torch.linalg.solve_triangular(chol, eye.expand_as(K), upper=False)
        Ct = C.transpose(-1, -2)
        for _ in range(iters):
            rhs = sigma_t * x - g + _mv(At, r * zo - yo) + (r * zx - yx)
            x = _mv(Ct, _mv(C, rhs))
            Ax = _mv(A, x)
            zx_t = alpha_t * x + one_m_alpha * zx
            zx_n = torch.minimum(torch.maximum(zx_t + yx / r, lx), ux)
            yx = yx + r * (zx_t - zx_n)
            zx = zx_n
            zo_t = alpha_t * Ax + one_m_alpha * zo
            zo_n = torch.minimum(torch.maximum(zo_t + yo / r, lo), hi)
            yo = yo + r * (zo_t - zo_n)
            zo = zo_n
        Ax = _mv(A, x)
        Hx = _mv(H, x)
        Aty = _mv(At, yo) + yx
        prim = _amax(x - zx, Ax - zo)
        dual = _amax(Hx + g + Aty)
        p_sc = torch.maximum(_amax(x, Ax), _amax(zx, zo)) + 1e-9
        d_sc = torch.maximum(_amax(Hx, Aty), _amax(g)) + 1e-9
        ratio = torch.sqrt((prim / p_sc) / (dual / d_sc + 1e-12))
        rho_s = torch.clamp(rho_s * torch.clamp(ratio, 0.2, 5.0), 1e-6, 1e8)
        return (x, zx, zo, yx, yo, rho_s), (prim, dual, p_sc, d_sc)

    A, lo, hi, d = relinearize(U0)
    zv = torch.zeros_like(g)
    zo0 = torch.zeros_like(lo)
    c = (zv, zv, zo0, zv, zo0, rho_s)
    for _ in range(n_seg0):
        c, res = segment(c, A, lo, hi, it0)
    for _ in range(sqp_rest):
        x, zx, _, yx, yo, rho_s = c
        A, lo, hi, d_new = relinearize(x)
        yo = yo * (d / d_new)
        d = d_new
        c, res = segment((x, zx, _mv(A, x), yx, yo, rho_s), A, lo, hi,
                         it_rest)
    prim, dual, p_sc, d_sc = res
    conv = (prim < tol * p_sc) & (dual < 10.0 * tol * d_sc)
    stats = torch.stack([conv.to(dtype), prim, dual, p_sc, d_sc], dim=1)
    return c[0], stats
