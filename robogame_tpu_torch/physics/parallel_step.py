"""Parallel-resolution batched control step (``engine="pallas"``).

Counterpart of the JAX package's ``physics/pallas_step.py`` in its modes
``full``, ``export`` and ``resume``: the sweep algorithm in one function,
called K6 below.  Per game and control step:

1. populate the 51-column x 20-component sub-step grid as the affine map
   M [x; u] (plus the populate noise plane in stochastic mode; there is no
   re-propagation noise in this step);
2. detect the first qualifying wall or pair event of every entity from
   its base column, then drop the events of an already-scored puck;
3. loop while the game has a valid slot and fewer than ``cap`` loop
   iterations ran:
   * take every slot that no conflicting valid slot beats (earlier, or as
     early with a lower index);
   * resolve every taken slot from the grid as it stood at the start of
     the iteration (partial RK4 to the event time, de-penetration, impulse
     and damage for a pair, flip and goal latch for a wall, RK4 to the
     next column, overlap correction there; a goal zeroes the puck);
   * claim the primary entity and, for a pair, its partner;
   * re-propagate each claimed entity without feedback: z = Finvpow[base]
     (x_base - Spow[base] u), the tail M [z; u], and per column the
     pair correction against the partner's uncorrected tail or the wall
     correction of the event's wall;
   * columns > base take the corrected tail, the column at base the
     uncorrected one; move the claimed entities' bases; count activity;
     re-detect every entity from its base;
4. finalize: decided games keep their inputs; meta rows 0/1 scores, 2
   time, 3 activity, 4 this call's loop trips (per game; JAX counts them
   per 128-game tile), 5 pending at the cap.

Export writes the grid and a 32-row carry (base 5, scored, incA, incB,
damage 16, activity); resume restarts from that carry with a fresh detect
from the imported bases.  Because every iteration ends in a full
re-detect, the carry holds no slots, and two-phase equals one-phase.

K6 has two implementations with the same interface:

* the hand-written CUDA kernel ``csrc/parallel_step.cu`` (``kernels.py``),
  for every CUDA tensor;
* :func:`parallel_step_plain`, the same function written with batched
  tensor ops (slots and entities as a (B, 5) axis), for CPU tensors and,
  on the card, as the kernel's yardstick in ``chip_smoke.py``.

The populate and the tail sum the six non-zeros of each row of M in
``_NZ`` order, z sums FI's 4 x 4 and SP's 4 x 2 blocks in a fixed order,
and every division is a true f32 division, so the two versions run the
same IEEE operations.  JAX's dense 32-term dots differ from these sums in
f32 roundoff only.
"""

from __future__ import annotations

import torch

from ..config import PUCK, SimParams
from ..plain import plain_version
from .exact_step import (E, NC, _INF, _NZ, _Tabs, _compact_lanes,
                         _detect_plain, _div, _rk4, _tabs, _to_grid,
                         _to_plane)
from .sweep import _take

CARRY_ROWS = 32
MODES = ("full", "export", "resume")


def _detect_stacked(gr, base, scored, T: _Tabs):
    """Detect every entity from its base (B, 5), then drop the events that
    involve an already-scored puck (the scored latch)."""
    t, j, c, v = _detect_plain(gr, base, T)
    ents = torch.arange(E, device=gr.device)
    pv = (ents == PUCK) | ((c == 4) & (j == PUCK))
    return t, j, c, v & ~(pv & scored[:, None])


@plain_version
def parallel_step_plain(T: _Tabs, x, u, meta, dmg, noise=None, grid_in=None,
                        carry_in=None, mode: str = "full", cap: int = 50):
    """K6 in batched PyTorch ops over the planes (see :func:`_kernel_call`).
    Returns (xout (20,B), aux (24,B) = meta 8 + dmg 16, grid (20,G+1,B),
    carry (32,B)); the last two matter in export mode only."""
    c = T.c
    G = T.G
    B = x.shape[1]
    dev = x.device
    X, U = x.T, u.T
    ents = torch.arange(E, device=dev)
    undec = (meta[0] < c["ws"]) & (meta[1] < c["ws"])
    if mode == "resume":
        gr = _to_grid(grid_in).clone()
        cr = carry_in.T
        base = cr[:, 0:5].to(torch.int64)
        scored = cr[:, 5] > 0.5
        incA, incB = cr[:, 6].clone(), cr[:, 7].clone()
        dacc = cr[:, 8:24].clone()
        actv = cr[:, 24].clone()
    else:
        z = torch.cat([X, U, X.new_zeros((B, 2))], dim=1)[:, _NZ]
        acc = T.M6[None, :, :, 0] * z[:, :, None, 0]
        for s in range(1, 6):
            acc = acc + T.M6[None, :, :, s] * z[:, :, None, s]
        if noise is not None:
            acc = acc + noise.permute(2, 0, 1)
        gr = acc.reshape(B, E, 4, G + 1)
        base = torch.ones((B, E), dtype=torch.int64, device=dev)
        scored = torch.zeros(B, dtype=torch.bool, device=dev)
        incA = x.new_zeros(B)
        incB = x.new_zeros(B)
        dacc = x.new_zeros((B, 16))
        actv = x.new_zeros(B)
    st, sj, sc, sv = _detect_stacked(gr, base, scored, T)

    # per-entity constants and controls, (B, 5) or (5,)
    r_e, m_e, tau_e, drag_e = T.r, T.m, T.tau, T.drag
    u_x, u_y = U[:, 0::2], U[:, 1::2]                      # (B, 5)
    M6r = T.M6.reshape(E, 4, G + 1, 6)
    FIr = T.FI.reshape(E, 16, G + 1).permute(0, 2, 1)      # (5, G+1, 16)
    SPr = T.SP.reshape(E, 8, G + 1).permute(0, 2, 1)       # (5, G+1, 8)
    kk = T.k                                               # (G+1,)
    rows = torch.arange(16, device=dev)
    trips = x.new_zeros(B)
    it = 0
    while it < cap and bool(sv.any()):
        active = sv.any(dim=1)

        # --- selection: the local minimum over the conflict graph -------
        te = torch.where(sv, st, _INF)
        is_pair = sc == 4
        jj = torch.where(is_pair, sj, ents)
        inv = ((ents[None, :, None] == ents[None, None, :])
               | (is_pair[:, :, None]
                  & (jj[:, :, None] == ents[None, None, :])))  # (B, a, ent)
        share = (inv[:, :, None, :] & inv[:, None, :, :]).any(-1)  # (B,a,b)
        earlier = ((te[:, None, :] < te[:, :, None])
                   | ((te[:, None, :] == te[:, :, None])
                      & (ents[None, :] < ents[:, None])))       # b before a
        beaten = (share & sv[:, :, None] & sv[:, None, :] & earlier
                  & (ents[:, None] != ents[None, :])).any(-1)
        take = sv & ~beaten

        # --- resolve every slot (used where taken) ----------------------
        tsafe = torch.where(take, te, 0.0)
        km1 = torch.clamp(_div(tsafe, c["dtcol"]).to(torch.int32), 0,
                          G - 1).to(torch.int64)                 # (B, 5)
        basea = km1 + 1
        at_km1 = km1[:, :, None, None].expand(B, E, 4, 1)
        xi = gr.gather(3, at_km1)[..., 0]                        # (B, 5, 4)
        xj = _take(gr, jj).gather(3, at_km1)[..., 0]
        r_j, m_j = r_e[jj], m_e[jj]
        tau_j, drag_j = tau_e[jj], drag_e[jj]
        u_jx, u_jy = u_x.gather(1, jj), u_y.gather(1, jj)
        dt_t = torch.clamp(tsafe - km1.to(torch.float32) * c["dtcol"], 0.0,
                           c["dtcol"])
        xi_t = _rk4(*xi.unbind(-1), u_x, u_y, tau_e, drag_e, dt_t)
        xj_t = _rk4(*xj.unbind(-1), u_jx, u_jy, tau_j, drag_j, dt_t)

        # pair: de-penetrate (1.01) + elastic impulse
        pijx = xj_t[0] - xi_t[0]
        pijy = xj_t[1] - xi_t[1]
        pn = torch.sqrt(pijx * pijx + pijy * pijy)
        rr = r_e + r_j
        ovl = rr - pn
        app = ovl > 0
        rsum = torch.where(rr > 0, rr, 1.0)
        ci = torch.where(app, 1.01 * r_e / rsum * ovl, 0.0)
        cj = torch.where(app, 1.01 * r_j / rsum * ovl, 0.0)
        p_ix = xi_t[0] - ci * pijx
        p_iy = xi_t[1] - ci * pijy
        p_jx = xj_t[0] + cj * pijx
        p_jy = xj_t[1] + cj * pijy
        d12x = p_ix - p_jx
        d12y = p_iy - p_jy
        den = d12x * d12x + d12y * d12y
        den = torch.where(den > 0, den, 1.0)
        rvx = xi_t[2] - xj_t[2]
        rvy = xi_t[3] - xj_t[3]
        dot = (rvx * d12x + rvy * d12y) / den
        mm = m_e + m_j
        msum = torch.where(mm > 0, mm, 1.0)
        vi_nx = xi_t[2] - 2.0 * m_j / msum * dot * d12x
        vi_ny = xi_t[3] - 2.0 * m_j / msum * dot * d12y
        vj_nx = xj_t[2] + 2.0 * m_e / msum * dot * d12x
        vj_ny = xj_t[3] + 2.0 * m_e / msum * dot * d12y

        # damage between two players, slots in order
        dv2 = 0.01 * (rvx * rvx + rvy * rvy)
        hit = take & is_pair & (ents != PUCK) & (jj != PUCK)
        for a in range(E - 1):
            on = hit[:, a, None]
            dacc = dacc + torch.where(on & (rows == (a * 4 + jj[:, a])[:, None]),
                                      (m_e[a] * dv2[:, a])[:, None], 0.0)
            dacc = dacc + torch.where(on & (rows == (jj[:, a] * 4 + a)[:, None]),
                                      (m_j[:, a] * dv2[:, a])[:, None], 0.0)

        # wall: sign-conditioned flip + goal
        ct = sc
        flip_y = ((ct == 0) & (xi_t[3] > 0)) | ((ct == 1) & (xi_t[3] < 0))
        flip_x = ((ct == 2) & (xi_t[2] > 0)) | ((ct == 3) & (xi_t[2] < 0))
        w_vx = torch.where(flip_x, -xi_t[2], xi_t[2])
        w_vy = torch.where(flip_y, -xi_t[3], xi_t[3])
        goal = (take & ~is_pair & (ents == PUCK) & ((ct == 2) | (ct == 3))
                & (xi_t[1] < c["gh2"]) & (xi_t[1] > -c["gh2"]))
        fresh = goal & ~scored[:, None]
        incA = incA + torch.where((fresh & (ct == 2)).any(1), 1.0, 0.0)
        incB = incB + torch.where((fresh & (ct == 3)).any(1), 1.0, 0.0)
        new_scored = scored | goal.any(1)

        # value at the base column
        xi_res = [torch.where(is_pair, p_ix, xi_t[0]),
                  torch.where(is_pair, p_iy, xi_t[1]),
                  torch.where(is_pair, vi_nx, w_vx),
                  torch.where(is_pair, vi_ny, w_vy)]
        rem = c["dtcol"] - dt_t
        xi_b = _rk4(*xi_res, u_x, u_y, tau_e, drag_e, rem)
        xj_b = _rk4(p_jx, p_jy, vj_nx, vj_ny, u_jx, u_jy, tau_j, drag_j, rem)
        pbx = xj_b[0] - xi_b[0]
        pby = xj_b[1] - xi_b[1]
        ov2 = rr - torch.sqrt(pbx * pbx + pby * pby)
        ap2 = ov2 > 0
        bri = c["buf"] * r_e / rsum
        brj = c["buf"] * r_j / rsum
        ci2 = torch.where(ap2, bri * ov2, 0.0)
        cj2 = torch.where(ap2, brj * ov2, 0.0)
        wbx, wby = _wall_fix(xi_b[0], xi_b[1], r_e, ct, T)
        xi_base = torch.stack([
            torch.where(is_pair, xi_b[0] - ci2 * pbx,
                        torch.where(goal, 0.0, wbx)),
            torch.where(is_pair, xi_b[1] - ci2 * pby,
                        torch.where(goal, 0.0, wby)),
            torch.where(is_pair, xi_b[2], torch.where(goal, 0.0, xi_b[2])),
            torch.where(is_pair, xi_b[3], torch.where(goal, 0.0, xi_b[3]))],
            dim=-1)                                              # (B, 5, 4)
        xj_base = torch.stack([xj_b[0] + cj2 * pbx, xj_b[1] + cj2 * pby,
                               xj_b[2], xj_b[3]], dim=-1)

        # --- claim entities: own slot, or the pair slot naming them -----
        pc = (take & is_pair)[:, :, None] & (jj[:, :, None] == ents) \
            & (ents[:, None] != ents[None, :])                   # (B, a, o)
        by_pair = pc.any(1)
        slot_p = torch.argmax(pc.to(torch.uint8), dim=1)         # (B, 5)
        claim = take | by_pair
        own = take[..., None]
        e_val = torch.where(own, xi_base, _take(xj_base, slot_p))
        e_base = torch.where(take, basea, basea.gather(1, slot_p))
        e_base = torch.where(claim, e_base, 0)
        e_ct = torch.where(take, ct, 4)
        e_pair = torch.where(take, is_pair, True)
        e_part = torch.where(take, jj, slot_p)

        # --- re-propagate without feedback: z, the tail, corrections ----
        fi = FIr[ents, e_base]                                   # (B, 5, 16)
        sp = SPr[ents, e_base]                                   # (B, 5, 8)
        xb = [e_val[..., cc] - (sp[..., cc * 2] * u_x
                                + sp[..., cc * 2 + 1] * u_y)
              for cc in range(4)]
        zs = []
        for i in range(4):
            zi = fi[..., i * 4] * xb[0]
            for j in range(1, 4):
                zi = zi + fi[..., i * 4 + j] * xb[j]
            zs.append(zi)
        zu = torch.stack(zs + [u_x, u_y], dim=-1)                # (B, 5, 6)
        tail = M6r[None, ..., 0] * zu[:, :, None, None, 0]
        for s in range(1, 6):
            tail = tail + M6r[None, ..., s] * zu[:, :, None, None, s]
        # (B, 5, 4, G+1); the partner's uncorrected tail
        ptail = _take(tail, e_part)
        ex, ey = tail[:, :, 0], tail[:, :, 1]
        dx = ptail[:, :, 0] - ex
        dy = ptail[:, :, 1] - ey
        pnt = torch.sqrt(dx * dx + dy * dy)
        rre = r_e + r_e[e_part]
        ovt = rre[..., None] - pnt
        rs = torch.where(rre > 0, rre, 1.0)
        bre = (c["buf"] * r_e / rs)[..., None]
        ce = torch.where(ovt > 0, bre * ovt, 0.0)
        wx, wy = _wall_fix(ex, ey, r_e[:, None], e_ct[..., None], T)
        isp = e_pair[..., None]
        cx = torch.where(isp, ex - ce * dx, wx)
        cy = torch.where(isp, ey - ce * dy, wy)
        corr = torch.stack([cx, cy, tail[:, :, 2], tail[:, :, 3]], dim=2)

        # --- blend: > base the corrected tail, == base the tail ---------
        gt = (claim[..., None] & (kk > e_base[..., None]))[:, :, None, :]
        eq = (claim[..., None] & (kk == e_base[..., None]))[:, :, None, :]
        gr_new = torch.where(gt, corr, torch.where(eq, tail, gr))
        base_new = torch.where(claim, e_base, base)

        st2, sj2, sc2, sv2 = _detect_stacked(gr_new, base_new, new_scored, T)
        a1 = active[:, None]
        gr = torch.where(active[:, None, None, None], gr_new, gr)
        base = torch.where(a1, base_new, base)
        scored = torch.where(active, new_scored, scored)
        st = torch.where(a1, st2, st)
        sj = torch.where(a1, sj2, sj)
        sc = torch.where(a1, sc2, sc)
        sv = torch.where(a1, sv2, sv)
        one = torch.where(active, 1.0, 0.0)
        actv = actv + one
        trips = trips + one
        it += 1

    xfin = gr[:, :, :, G].reshape(B, NC)
    xout = torch.where(undec[:, None], xfin, X)
    u01 = torch.where(undec, 1.0, 0.0)
    pend = torch.where(sv.any(dim=1) & undec, 1.0, 0.0)
    zero = x.new_zeros(B)
    aux = torch.stack([meta[0] + u01 * incA, meta[1] + u01 * incB,
                       meta[2] + u01 * c["dt"], actv, trips, pend,
                       zero, zero], dim=1)
    aux = torch.cat([aux, dmg.T + u01[:, None] * dacc], dim=1)
    carry = torch.cat([base.to(torch.float32), scored.to(torch.float32)[:, None],
                       incA[:, None], incB[:, None], dacc, actv[:, None],
                       x.new_zeros((B, 7))], dim=1)
    return (xout.T.contiguous(), aux.T.contiguous(), _to_plane(gr),
            carry.T.contiguous())


def _wall_fix(px, py, r, ct, T: _Tabs):
    """The overlap correction against the wall ``ct`` (0-3; 4, a pair,
    leaves the point): ``buf * overlap`` along the wall's inward normal."""
    c = T.c
    isy = ct <= 1
    sgn = torch.where((ct == 0) | (ct == 2), 1.0, -1.0)
    half = torch.where(isy, c["halfy"], c["halfx"])
    ow = sgn * torch.where(isy, py, px) + r - half
    on = (ct < 4) & (ow > 0)
    cw = c["buf"] * ow
    return (px + torch.where(on, cw * T.dirx[ct], 0.0),
            py + torch.where(on, cw * T.diry[ct], 0.0))


# ---------------------------------------------------------------------------
# Dispatch and two-phase
# ---------------------------------------------------------------------------

def _kernel_call(planes, u, params: SimParams, noise_plane=None,
                 mode: str = "full", cap: int = None, grid_in=None,
                 carry_in=None):
    """One K6 invocation over lane-major planes: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    ``cap`` is the loop budget in iterations (default sweep_iters).
    Stochastic runs take the populate noise plane (modes full and export).
    Returns (x, meta, dmg); export also returns the grid (20, G+1, B) and
    the 32-row carry that resume restarts from (``grid_in`` is not
    modified)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    x, meta, dmg = planes
    if cap is None:
        cap = params.sweep_iters
    noise = noise_plane if params.stochastic and mode != "resume" else None
    if params.stochastic and mode != "resume" and noise is None:
        raise ValueError("stochastic K6 needs its populate noise plane")
    if mode == "resume" and (grid_in is None or carry_in is None):
        raise ValueError("resume needs grid_in and carry_in")
    T = _tabs(params, x.device)
    if x.device.type == "cuda":
        from .. import kernels
        xout, aux, grid, carry = kernels.parallel_step(
            T.M6, T.FI, T.SP, T.consts, x, u, meta, dmg, noise, grid_in,
            carry_in, mode, cap)
    elif x.device.type == "cpu":
        xout, aux, grid, carry = parallel_step_plain(
            T, x, u, meta, dmg, noise, grid_in, carry_in, mode, cap)
    else:
        raise ValueError(f"K6 runs on cuda or cpu tensors, not {x.device}")
    out = (xout, aux[0:8], aux[8:24])
    if mode == "export":
        return out, grid, carry
    return out


def _twophase_planes(planes, u, params: SimParams, noise_plane=None):
    """Two-phase compact-and-resume.  Phase 1 caps every game at
    ``phase1_iters`` loop iterations and exports the loop state; the
    pending games are gathered into K lanes (B/compact_frac in whole
    32-game blocks) and finished at the remaining budget, their results
    scattered back.  When more than K games are pending the resume runs
    over the full batch instead, so the result equals one-phase bitwise at
    every pending count (meta row 4 counts each call's own trips).  The
    pending count is one host fetch per step."""
    x_in, meta_in, dmg_in = planes
    B = x_in.shape[1]
    p1 = params.phase1_iters
    rest = params.sweep_iters - p1
    (x1, meta1, dmg1), grid, carry = _kernel_call(
        planes, u, params, noise_plane, mode="export", cap=p1)
    K = _compact_lanes(B, params)
    pending = meta1[5]
    if K >= B or int((pending > 0.5).sum()) > K:
        return _kernel_call(planes, u, params, mode="resume", cap=rest,
                            grid_in=grid, carry_in=carry)
    idx = torch.argsort(-pending, stable=True)[:K]
    x2, meta2, dmg2 = _kernel_call(
        (x_in[:, idx], meta_in[:, idx], dmg_in[:, idx]), u[:, idx], params,
        mode="resume", cap=rest, grid_in=grid[..., idx],
        carry_in=carry[:, idx])
    x1[:, idx] = x2
    meta1[:, idx] = meta2
    dmg1[:, idx] = dmg2
    return x1, meta1, dmg1

