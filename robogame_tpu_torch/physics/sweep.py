"""Closed-form sub-step tables, the stochastic noise model, and the sweep
step (``engine="sweep"``).

Between collisions the dynamics are LTI (damped double integrators, input
constant over the control step), so one RK4 sub-step is a constant affine
map ``x' = F x + S u`` and grid column k is ``x_k = F^k x_0 + S_k u``.  The
tables are float64 numpy, built once per parameter set.

Noise: the reference draws fresh normals inside every RK4 stage.  Per
sub-step that is an additive Gaussian with covariance ``w^2 sum_s M_s M_s^T``;
one 4-vector per sub-step is drawn through its Cholesky factor L.  Each
noise function is split in two -- draw standard normals ``xi``
(:func:`game_draws`, from each game's stream in :mod:`.noise`), and
transform a given ``xi`` -- so tests can feed the same xi to this port and
to the JAX package.

The sweep step (:func:`step_sweep`) is the JAX package's
``physics/sweep.py::step_sweep`` written out over a leading game axis:
closed-form populate, the local-minimum disjoint event selection, all
selected events resolved at once, and the closed-form tail
re-propagation with feedback-free overlap corrections, looped while any
game has a valid slot.  It is plain PyTorch in the params' dtype on
either device (in JAX it is an XLA program, not a Pallas kernel) and is
the semantic anchor of the parallel-resolution kernel K6
(:mod:`.parallel_step`).  Unlike K6 it keeps the slots of entities no
event touched instead of re-detecting them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import INTER_AGENT, PUCK, SimParams
from ..state import GameState, undecided
from .dynamics import entity_consts, rk4_step
from .engine import _INF, _Slots, _detect
from .noise import advance_keys, game_normals


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


def game_draws(states, sizes):
    """Standard normals of a stochastic step: for each n in ``sizes``, in
    order, (B, n, 4, 4) float32 from substream i (``physics/noise.py``:
    0 the populate, 1 K1's re-propagation) of each game's Philox stream,
    keyed by its seed at counter word (counter + 1); and the keys advanced
    by one.  One draw-kernel launch a size on the states' device (the plain
    version on the CPU), no host sync; a game's noise depends on its own
    key only."""
    B = states.key.shape[0]
    draws = [game_normals(states.key, n * 16, s).view(B, n, 4, 4)
             for s, n in enumerate(sizes)]
    return draws, advance_keys(states.key)


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


@functools.lru_cache(maxsize=32)
def _affine_tables_cached(key, dtype: torch.dtype, device: torch.device):
    Fpow, Spow, L = _affine_tables_np(SimParams(**dict(key)))
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in (Fpow, Spow, L))


def _affine_tables(params: SimParams, device) -> tuple:
    """(Fpow (G+1,5,4,4), Spow (G+1,5,4,2), L (4,4)) as tensors in the
    params' dtype on ``device``, cached per device and dtype."""
    return _affine_tables_cached(_noise_key(params), params.torch_dtype,
                                 torch.device(device))


# ---------------------------------------------------------------------------
# Vectorized overlap corrections (slot / column batched)
# ---------------------------------------------------------------------------

def _pair_correct_v(p_i, p_j, r_i, r_j, buffer):
    """De-penetration along the *unnormalized* relative position (a
    reference quirk), batched over any leading dims; r_i / r_j
    broadcastable to them."""
    pij = p_j - p_i
    overlap = r_i + r_j - torch.linalg.vector_norm(pij, dim=-1)
    apply = overlap > 0
    coef_i = torch.where(apply, buffer * r_i / (r_i + r_j) * overlap, 0.0)
    coef_j = torch.where(apply, buffer * r_j / (r_i + r_j) * overlap, 0.0)
    return p_i - coef_i[..., None] * pij, p_j + coef_j[..., None] * pij


_WALL_DIRS = ((0.0, -1.0), (0.0, 1.0), (-1.0, 0.0), (1.0, 0.0))


def _wall_correct_v(x, r, ctype, halfx, halfy, buffer):
    """Unit-normal wall fix-up, batched: x (..., 4), r and ctype
    broadcastable to (...,); ctype 4 (a pair) leaves x as it is."""
    p = x[..., 0:2]
    overlaps = torch.stack([p[..., 1] + r - halfy,       # UP
                            -p[..., 1] + r - halfy,      # DOWN
                            p[..., 0] + r - halfx,       # RIGHT
                            -p[..., 0] + r - halfx],     # LEFT
                           dim=-1)
    dirs = torch.tensor(_WALL_DIRS, dtype=x.dtype, device=x.device)
    w = torch.clamp(ctype, 0, 3).expand(overlaps.shape[:-1])
    overlap = overlaps.gather(-1, w[..., None])[..., 0]
    corr = torch.where(overlap > 0, buffer * overlap, 0.0)[..., None] * dirs[w]
    corr = torch.where((ctype < 4)[..., None], corr, 0.0)
    return torch.cat([p + corr, x[..., 2:4]], dim=-1)


# ---------------------------------------------------------------------------
# The sweep step
# ---------------------------------------------------------------------------

def _take(a, idx):
    """a (B, 5, ...) gathered along the entity axis at idx (B, n)."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


def step_sweep(states: GameState, controls: torch.Tensor,
               params: SimParams) -> GameState:
    """One control step of every game (``engine="sweep"``), on the states'
    device in the params' dtype; controls (B, 4, 2).  Decided games keep
    their state.  In stochastic mode game b's populate noise is substream
    0 of its Philox stream (:func:`game_draws`), as on the kernel paths,
    and every game's key advances."""
    new_keys = states.key
    noise = None
    if params.stochastic:
        (xi,), new_keys = game_draws(states, (params.grid_points,))
        noise = populate_noise(xi, params).to(params.torch_dtype)
    new = _update_sweep(states, controls, params, noise)
    keep = undecided(states, params)
    sel = lambda n, o: torch.where(keep.view(-1, *([1] * (n.ndim - 1))), n, o)
    return GameState(x=sel(new.x, states.x), score=sel(new.score,
                                                         states.score),
                     damage=sel(new.damage, states.damage),
                     t=sel(new.t, states.t), key=new_keys)


def _update_sweep(state: GameState, controls, params: SimParams,
                  noise=None) -> GameState:
    """The sweep step of every game, decided or not; ``noise`` is the
    populate noise (B, G, 4 players, 4) or None.  JAX ``vmap``s a
    ``while_loop``, so each game runs its own trip count: here the loop
    runs while any game has a valid slot, and a game whose loop has ended
    keeps its carry bitwise (selected, not blended)."""
    G = params.grid_points
    dtype = params.torch_dtype
    dev = state.x.device
    B = state.x.shape[0]
    tau, drag, radius, mass = entity_consts(params, dev)
    Fpow, Spow, _ = _affine_tables(params, dev)
    dtcol = params.dt_col
    halfx, halfy = params.arena_x / 2.0, params.arena_y / 2.0
    buf = params.overlap_buffer
    gh2 = params.goal_height / 2.0
    ids = torch.arange(5, device=dev)
    bi = torch.arange(B, device=dev)
    eye = torch.eye(5, dtype=torch.bool, device=dev)

    inputs = torch.cat([controls.to(dtype).reshape(B, 4, 2),
                        torch.zeros((B, 1, 2), dtype=dtype, device=dev)],
                       dim=1)                                   # (B, 5, 2)
    t0 = state.t
    x0 = state.x.to(dtype)

    # --- populate in closed form (elementwise products and sums: no
    # matmul, so no TF32 on the card) --------------------------------------
    grid = ((Fpow[None] * x0[:, None, :, None, :]).sum(-1)
            + (Spow[None] * inputs[:, None, :, None, :]).sum(-1))
    if noise is not None:
        grid[:, 1:, :4, :] += noise
    slots = _detect(grid, torch.ones((B, 5), dtype=torch.int64, device=dev),
                    t0, params, radius)
    scored = torch.zeros(B, dtype=torch.bool, device=dev)
    score, dmg = state.score, state.damage.to(dtype)

    for _ in range(params.sweep_iters):
        active = slots.valid.any(dim=1)
        if not bool(active.any()):
            break
        valid = slots.valid
        is_pair = slots.ctype == INTER_AGENT
        jj = torch.where(is_pair, slots.j, ids)             # partner or self
        t_a = torch.where(valid, slots.t, _INF)

        # --- local-minimum disjoint event selection ---------------------
        inv = ((ids[None, None, :] == ids[None, :, None])
               | (is_pair[:, :, None]
                  & (ids[None, None, :] == jj[:, :, None])))  # (B, slot, ent)
        share = (inv[:, :, None, :] & inv[:, None, :, :]).any(-1)
        conflict = share & ~eye & valid[:, :, None] & valid[:, None, :]
        beats = conflict & ((t_a[:, :, None] < t_a[:, None, :])
                            | ((t_a[:, :, None] == t_a[:, None, :])
                               & (ids[:, None] < ids[None, :])))
        take = valid & ~beats.any(dim=1)
        puck_inv = (ids == PUCK) | (is_pair & (jj == PUCK))
        skip = take & puck_inv & scored[:, None]             # scored latch
        live = take & ~skip

        # --- resolve all live slots at once ------------------------------
        km1 = torch.clamp(torch.floor((t_a - t0[:, None]) / dtcol).to(
            torch.int64), 0, G - 1)
        base_a = km1 + 1                                     # (B, 5)
        ents = torch.stack([ids.expand(B, 5), jj], dim=2)     # (B, 5, 2)
        xs_m = grid[bi[:, None, None], km1[:, :, None], ents]  # (B,5,2,4)
        us = inputs[bi[:, None, None], ents]                  # (B,5,2,2)
        dt_t = torch.clamp(t_a - (t0[:, None] + km1.to(dtype) * dtcol),
                           0.0, dtcol)
        xs_t = rk4_step(xs_m, us, dt_t[:, :, None], tau[ents], drag[ents])
        r_i, r_j = radius, radius[jj]
        m_i, m_j = mass, mass[jj]

        # pair: de-penetrate (1.01) + elastic impulse
        p_i, p_j = _pair_correct_v(xs_t[:, :, 0, 0:2], xs_t[:, :, 1, 0:2],
                                   r_i, r_j, 1.01)
        v1, v2 = xs_t[:, :, 0, 2:4], xs_t[:, :, 1, 2:4]
        d12 = p_i - p_j
        den = (d12 * d12).sum(-1)
        den_safe = torch.where(den > 0, den, 1.0)
        dot_v = ((v1 - v2) * d12).sum(-1)
        imp = (dot_v / den_safe)[..., None] * d12
        vi_new = v1 - (2.0 * m_j / (m_i + m_j))[..., None] * imp
        vj_new = v2 + (2.0 * m_i / (m_i + m_j))[..., None] * imp
        xi_pair = torch.cat([p_i, vi_new], dim=-1)
        xj_pair = torch.cat([p_j, vj_new], dim=-1)

        dmg_on = live & is_pair & (ids != PUCK) & (jj != PUCK)
        dv2 = 0.01 * ((v1 - v2) ** 2).sum(-1)
        di, dj = torch.clamp(ids, 0, 3).expand(B, 5), torch.clamp(jj, 0, 3)
        flat = dmg.reshape(B, 16)
        flat = flat.scatter_add(1, di * 4 + dj,
                                torch.where(dmg_on, m_i * dv2, 0.0))
        flat = flat.scatter_add(1, dj * 4 + di,
                                torch.where(dmg_on, m_j * dv2, 0.0))
        dmg_new = flat.reshape(B, 4, 4)

        # wall: sign-conditioned flip + goal test
        ctype = slots.ctype
        vx, vy = xs_t[:, :, 0, 2], xs_t[:, :, 0, 3]
        flip_y = ((ctype == 0) & (vy > 0)) | ((ctype == 1) & (vy < 0))
        flip_x = ((ctype == 2) & (vx > 0)) | ((ctype == 3) & (vx < 0))
        x_wall = torch.cat([xs_t[:, :, 0, 0:2],
                            (vx * torch.where(flip_x, -1.0, 1.0))[..., None],
                            (vy * torch.where(flip_y, -1.0, 1.0))[..., None]],
                           dim=-1)
        py = xs_t[:, :, 0, 1]
        goal = (~is_pair & (ids == PUCK) & ((ctype == 2) | (ctype == 3))
                & (py < gh2) & (py > -gh2) & live)
        fresh = goal & ~scored[:, None]
        any_goal = fresh.any(dim=1)
        right_goal = (fresh & (ctype == 2)).any(dim=1)
        inc = torch.stack([any_goal & right_goal, any_goal & ~right_goal],
                          dim=1).to(score.dtype)
        score_new = score + inc
        scored_new = scored | goal.any(dim=1)

        # propagate the resolved states to their base columns + corrections
        xres = torch.stack([torch.where(is_pair[..., None], xi_pair, x_wall),
                            xj_pair], dim=2)                  # (B, 5, 2, 4)
        xprop = rk4_step(xres, us, (dtcol - dt_t)[:, :, None], tau[ents],
                         drag[ents])
        pi_c, pj_c = _pair_correct_v(xprop[:, :, 0, 0:2], xprop[:, :, 1, 0:2],
                                     r_i, r_j, buf)
        xi_base_pair = torch.cat([pi_c, xprop[:, :, 0, 2:4]], dim=-1)
        xj_base = torch.cat([pj_c, xprop[:, :, 1, 2:4]], dim=-1)
        xi_base_wall = _wall_correct_v(xprop[:, :, 0], r_i, ctype, halfx,
                                       halfy, buf)
        xi_base = torch.where(is_pair[..., None], xi_base_pair,
                              torch.where(goal[..., None], 0.0,
                                          xi_base_wall))

        # --- slot -> entity mapping -------------------------------------
        claim = live[:, :, None] & inv                        # (B, slot, ent)
        claimed = claim.any(dim=1)                            # (B, 5)
        slot_of = torch.argmax(claim.to(torch.uint8), dim=1)  # (B, 5)
        primary = slot_of == ids
        ent_val = torch.where(primary[..., None], _take(xi_base, slot_of),
                              _take(xj_base, slot_of))        # (B, 5, 4)
        ent_base = base_a.gather(1, slot_of)                  # (B, 5)
        grid1 = grid.clone()
        col_vals = grid[bi[:, None], ent_base, ids]
        grid1[bi[:, None], ent_base, ids] = torch.where(
            claimed[..., None], ent_val, col_vals)

        # --- closed-form tail re-propagation + feedback-free corrections
        k_idx = torch.arange(1, G + 1, device=dev)[None, :, None]  # (1,G,1)
        dtl = torch.clamp(k_idx - ent_base[:, None, :], 0, G)    # (B, G, 5)
        Fd = Fpow[dtl, ids]                                   # (B,G,5,4,4)
        Sd = Spow[dtl, ids]                                   # (B,G,5,4,2)
        x_tail = ((Fd * ent_val[:, None, :, None, :]).sum(-1)
                  + (Sd * inputs[:, None, :, None, :]).sum(-1))  # (B,G,5,4)
        ent_ctype = ctype.gather(1, slot_of)
        ent_pair = is_pair.gather(1, slot_of)
        partner = torch.where(primary, jj.gather(1, slot_of), slot_of)
        part_tail = x_tail.gather(
            2, partner[:, None, :, None].expand(B, G, 5, 4))
        pe_c, _ = _pair_correct_v(x_tail[..., 0:2], part_tail[..., 0:2],
                                  radius, radius[partner][:, None, :], buf)
        tail_pair = torch.cat([pe_c, x_tail[..., 2:4]], dim=-1)
        tail_wall = _wall_correct_v(x_tail, radius, ent_ctype[:, None, :],
                                    halfx, halfy, buf)
        tail = torch.where(ent_pair[:, None, :, None], tail_pair, tail_wall)
        apply = claimed[:, None, :] & (k_idx > ent_base[:, None, :])
        grid_new = torch.cat([grid1[:, :1],
                              torch.where(apply[..., None], tail,
                                          grid1[:, 1:])], dim=1)

        # --- slot bookkeeping --------------------------------------------
        refs_touched = (inv & claimed[:, None, :]).any(dim=-1)   # slots
        keep_valid = valid & ~refs_touched & ~skip
        redet = _detect(grid_new, torch.where(claimed, ent_base, 1), t0,
                        params, radius)
        slots_new = _Slots(
            t=torch.where(claimed, redet.t, slots.t),
            j=torch.where(claimed, redet.j, slots.j),
            ctype=torch.where(claimed, redet.ctype, slots.ctype),
            valid=torch.where(claimed, redet.valid, keep_valid))

        # a game whose loop has ended keeps its carry as it is
        a1 = active[:, None]
        grid = torch.where(active[:, None, None, None], grid_new, grid)
        slots = _Slots(*(torch.where(a1, n, o)
                         for n, o in zip(slots_new, slots)))
        scored = torch.where(active, scored_new, scored)
        score = torch.where(a1, score_new, score)
        dmg = torch.where(active[:, None, None], dmg_new, dmg)

    return GameState(x=grid[:, G], score=score, damage=dmg,
                     t=t0 + params.dt, key=state.key)
