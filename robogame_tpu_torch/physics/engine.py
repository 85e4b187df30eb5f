"""The event engine (``engine="event"``), batched over games.

Counterpart of the JAX package's ``physics/engine.py``, the reference's
``GameSim::updateSim`` as plain PyTorch: populate a (G+1)-column sub-step
grid with RK4, then repeatedly pop the globally earliest pending
collision, resolve it (elastic impulse with damage, or a wall flip with
the goal test and the scored latch), re-propagate the affected entities
over the remaining columns with per-column overlap corrections, and
re-detect only those entities.  Detection keeps one pending-collision
slot per entity.

JAX ``vmap``s a ``while_loop``; here the loop runs on the host while any
game has a pending slot (one host sync an iteration, which also says
whether any looping game pops a pair or a wall event, so that a fix-up
no game takes is not computed) and every write is masked by the game's
own ``active`` flag, so a game whose loop has ended
keeps its carry bitwise.  A game never becomes active again, so the one
shared counter equals each active game's own.  The float evaluation
order of every formula is the reference's, term by term (that order is
what holds float64 runs to the compiled reference's golden logs), and
no value is divided by a host scalar (CUDA divides by one through its
reciprocal).

Everything runs in the params' dtype on the states' device.  Stochastic
steps draw each game's noise from its own Philox stream
(``physics/noise.py``): the populate from substream 2, loop iteration k
from substream 3 at iteration word k, one draw-kernel launch each for the
whole batch on the card, so a game's noise depends on its own key and
iteration index alone, and the stochastic loop syncs with the host once
an iteration, as the deterministic one does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import INTER_AGENT, PUCK, SimParams
from ..state import GameState
from .dynamics import entity_consts
from .noise import (EVENT_ITERATION, EVENT_POPULATE, advance_keys,
                    game_normals)

_INF = 1.0e9  # "no collision" sentinel (the reference's Collision() t)


class _Slots(NamedTuple):
    """Pending earliest collision per detecting entity, each (B, 5)."""
    t: torch.Tensor       # collision time (INF if none)
    j: torch.Tensor       # int64 other entity (-1 for walls)
    ctype: torch.Tensor   # int64 collision type (WALL_* or INTER_AGENT)
    valid: torch.Tensor   # bool


def _safe_div(num, den):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), _INF)


def _detect(grid, base_idx, t0, params: SimParams, radius) -> _Slots:
    """Each entity's first qualifying collision scanning grid columns
    ``base_idx..G``, for all entities at once (the caller masks which
    slots to update).

    grid (B, G+1, 5, 4); base_idx (B, 5) integer; t0 (B,); radius (5,).
    Per column the 9 candidates are the walls UP, DOWN, RIGHT, LEFT, then
    the other entities ascending; the first minimum wins (the reference
    compares with strict <), and a column qualifies when its minimum lies
    less than dt after t0."""
    G = params.grid_points
    dtype = grid.dtype
    dev = grid.device
    dtcol = params.dt_col
    halfx = params.arena_x / 2.0
    halfy = params.arena_y / 2.0

    pos_k = grid[:, 1:, :, 0:2]                 # (B, G, 5, 2) columns 1..G
    pos_m = grid[:, :-1, :, 0:2]                # column k-1
    vel_m = grid[:, :-1, :, 2:4]
    r = radius
    t_m = t0[:, None, None] + dtcol * torch.arange(
        G, dtype=dtype, device=dev)[None, :, None]           # (B, G, 1)

    def wall(axis, sign, bound):
        overlap = sign * pos_k[..., axis] + r >= bound       # (B, G, 5)
        v = vel_m[..., axis]
        approaching = sign * v > 0
        tau = torch.clamp_min(
            _safe_div((bound - r) * sign - pos_m[..., axis], v), 0.0)
        return torch.where(overlap & approaching, t_m + tau, _INF)

    cand_walls = torch.stack([wall(1, 1.0, halfy), wall(1, -1.0, halfy),
                              wall(0, 1.0, halfx), wall(0, -1.0, halfx)],
                             dim=-1)                         # (B, G, 5, 4)

    dp_k = pos_k[:, :, None, :, :] - pos_k[:, :, :, None, :]  # [e, o] = o - e
    dist_k = torch.linalg.vector_norm(dp_k, dim=-1)          # (B, G, 5, 5)
    sigma = r[:, None] + r[None, :]
    overlap_k = dist_k <= sigma
    dp_m = pos_m[:, :, None, :, :] - pos_m[:, :, :, None, :]
    dv_m = vel_m[:, :, None, :, :] - vel_m[:, :, :, None, :]
    b = (dp_m * dv_m).sum(-1)
    dvv = (dv_m * dv_m).sum(-1)
    dpp = (dp_m * dp_m).sum(-1)
    disc = b * b - dvv * (dpp - sigma * sigma)
    ok = overlap_k & (b < 0) & (disc >= 0)
    tau = torch.clamp_min(
        _safe_div(-(b + torch.sqrt(torch.clamp_min(disc, 0.0))), dvv), 0.0)
    t_pair = t_m[..., None] + tau                            # (B, G, 5, 5)
    eye = torch.eye(grid.shape[2], dtype=torch.bool, device=dev)
    cand_pairs = torch.where(ok & ~eye, t_pair, _INF)

    cands = torch.cat([cand_walls, cand_pairs], dim=-1)      # (B, G, 5, 9)
    tmin, cidx = torch.min(cands, dim=-1)     # the first index of the min

    cols = torch.arange(1, G + 1, device=dev)[None, :, None]  # (1, G, 1)
    qualify = ((tmin - t0[:, None, None] < params.dt)
               & (cols >= base_idx[:, None, :]))             # (B, G, 5)
    found = qualify.any(dim=1)
    first = torch.argmax(qualify.to(torch.uint8), dim=1)     # (B, 5)
    sel_t = tmin.gather(1, first[:, None, :])[:, 0]
    sel_c = cidx.gather(1, first[:, None, :])[:, 0]
    is_pair = sel_c >= 4
    return _Slots(
        t=torch.where(found, sel_t, _INF),
        j=torch.where(is_pair, sel_c - 4, -1),
        ctype=torch.where(is_pair, INTER_AGENT, sel_c),
        valid=found,
    )


# ---------------------------------------------------------------------------
# Overlap corrections of each game's two involved rows
# ---------------------------------------------------------------------------

def _pair_coef(r_i, r_j, buffer):
    """The de-penetration coefficients of rows (e_i, e_j), (B, 2):
    (-buffer * r_i / (r_i + r_j), buffer * r_j / (r_i + r_j)), the
    reference's ``buffer * r/(r_i+r_j)`` term by term."""
    rsum = r_i + r_j
    return torch.stack([-(buffer * r_i / rsum), buffer * r_j / rsum], dim=1)


def _pair_overlap_correction(x2, rsum, coef, zero):
    """De-penetration of rows 0 and 1 of x2 (B, 2, 4) along the
    *unnormalized* relative position vector (a reference quirk): row k's
    position plus ``coef[:, k] * overlap * (p_1 - p_0)`` where the two
    overlap (p_0 - c p_01 is p_0 + (-c) p_01 exactly)."""
    pij = x2[:, 1, 0:2] - x2[:, 0, 0:2]
    overlap = rsum - torch.sqrt((pij * pij).sum(-1))
    c = torch.where((overlap > 0)[:, None], coef * overlap[:, None], zero)
    return torch.cat([x2[..., 0:2] + c[..., None] * pij[:, None],
                      x2[..., 2:4]], dim=-1)


@functools.lru_cache(maxsize=8)
def _wall_dirs(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The unit normals pointing away from the walls UP, DOWN, RIGHT,
    LEFT."""
    return torch.tensor(((0.0, -1.0), (0.0, 1.0), (-1.0, 0.0), (1.0, 0.0)),
                        dtype=dtype, device=device)


def _wall_terms(ctype, halfx, halfy, like):
    """Per-game terms of the fix-up against wall ``ctype`` (a pair's type
    gives LEFT's, unused): the axis (B, 1), the sign of the position in the
    overlap, the half extent, and the unit normal (B, 2)."""
    w = torch.clamp(ctype, 0, 3)
    axis = (w < 2).to(torch.int64)[:, None]          # UP, DOWN act on y
    sgn = (1 - 2 * (w % 2)).to(like.dtype)       # UP, RIGHT +; DOWN, LEFT -
    bound = torch.where(w < 2, halfy, halfx).to(like.dtype)
    return axis, sgn, bound, _wall_dirs(like.dtype, like.device)[w]


def _wall_overlap_correction(x, r, terms, buffer, zero):
    """Wall fix-up of x (B, 4) along each game's wall normal
    (``_wall_terms``): the overlap ``sgn * p + r - bound`` is the
    reference's term by term."""
    axis, sgn, bound, normal = terms
    p = x[:, 0:2]
    overlap = sgn * p.gather(1, axis)[:, 0] + r - bound
    corr = torch.where(overlap > 0, buffer * overlap, zero)[:, None] * normal
    return torch.cat([p + corr, x[:, 2:4]], dim=1)


# ---------------------------------------------------------------------------
# RK4 over precomputed step fractions, and the per-game noise
# ---------------------------------------------------------------------------

def _f(x, u, tau, drag, nz):
    """xdot of x (..., E, 4); tau and drag (..., E, 1)."""
    vel = x[..., 2:4]
    acc = (u - drag * vel) / tau
    if nz is not None:
        acc = acc + nz
    return torch.cat([vel, acc], dim=-1)


def _rk4(x, u, h, h2, h6, tau, drag, noise=None):
    """``dynamics.rk4_step`` with h/2 and h/6 given (true divisions made
    once by the caller): the same operations in the same order."""
    n = (None,) * 4 if noise is None else noise
    k1 = _f(x, u, tau, drag, n[0])
    k2 = _f(x + k1 * h2, u, tau, drag, n[1])
    k3 = _f(x + k2 * h2, u, tau, drag, n[2])
    k4 = _f(x + k3 * h, u, tau, drag, n[3])
    return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) * h6


def _with_puck_row(z):
    """(..., 4 players, 2) normals with a zero puck row appended, so
    (..., 5, 2): the puck draws nothing."""
    return torch.cat([z, z.new_zeros(z.shape[:-2] + (1, 2))], dim=-2)


def _populate_draws(key, params: SimParams) -> torch.Tensor:
    """(B, G, 4 stages, 5, 2) populate noise: w times each game's normals
    from substream 2 of its stream (``physics/noise.py``)."""
    G = params.grid_points
    B = key.shape[0]
    z = game_normals(key, G * 32, EVENT_POPULATE, 0, params.torch_dtype)
    return params.noise * _with_puck_row(z.view(B, G, 4, 4, 2))


def _iteration_draws(key, active, it: int, params: SimParams):
    """Loop iteration ``it``'s noise, substream 3 at iteration ``it`` of
    every game's stream, zeros for the games not looping (``active``
    (B,)): the resolve and base-column RK4s' (B, 4 stages, 2, 2) of the two
    involved rows, and the re-propagation's (B, G, 4 stages, 5, 2)."""
    G = params.grid_points
    B = key.shape[0]
    z = game_normals(key, 32 + G * 32, EVENT_ITERATION, it,
                     params.torch_dtype)
    z = params.noise * torch.where(active[:, None], z, 0.0)
    return (z[:, :16].view(B, 4, 2, 2), z[:, 16:32].view(B, 4, 2, 2),
            _with_puck_row(z[:, 32:].view(B, G, 4, 4, 2)))


# ---------------------------------------------------------------------------
# The event engine
# ---------------------------------------------------------------------------

def _update_sim(state: GameState, controls, params: SimParams):
    """One control step of every game, decided or not (the caller applies
    the keep mask).  Returns the new state, keys advanced in stochastic
    mode, and each game's loop iterations (B,)."""
    G = params.grid_points
    dtype = params.torch_dtype
    dev = state.x.device
    B = state.x.shape[0]
    tau, drag, radius, mass = entity_consts(params, dev)
    halfx, halfy = params.arena_x / 2.0, params.arena_y / 2.0
    buf = params.overlap_buffer
    gh2 = params.goal_height / 2.0
    ids = torch.arange(5, device=dev)
    bi = torch.arange(B, device=dev)
    scalar = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    zero, two, six = scalar(0.0), scalar(2.0), scalar(6.0)
    dtcol = scalar(params.dt_col)
    dtcol2, dtcol6 = dtcol / two, dtcol / six
    tau_e, drag_e = tau[:, None], drag[:, None]

    inputs = torch.cat([controls.to(dtype).reshape(B, 4, 2),
                        torch.zeros((B, 1, 2), dtype=dtype, device=dev)],
                       dim=1)                                   # (B, 5, 2)
    t0 = state.t.to(dtype)
    x = state.x.to(dtype)

    # --- 1. populate the sub-step grid ------------------------------------
    pop = _populate_draws(state.key, params) if params.stochastic else None
    cols = [x]
    for k in range(G):
        nz = None if pop is None else pop[:, k].unbind(1)
        x = _rk4(x, inputs, dtcol, dtcol2, dtcol6, tau_e, drag_e, nz)
        cols.append(x)
    grid = torch.stack(cols, dim=1)                          # (B, G+1, 5, 4)

    # --- 2. the event loop -----------------------------------------------
    slots = _detect(grid, torch.ones((B, 5), dtype=torch.int64, device=dev),
                    t0, params, radius)
    scored = torch.zeros(B, dtype=torch.bool, device=dev)
    score, dmg = state.score, state.damage.to(dtype)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    counter = 1
    while counter < params.collision_counter_lim:
        active = slots.valid.any(dim=1)
        # pop the earliest slot; ties go to the highest entity index
        t_eff = torch.where(slots.valid, slots.t, _INF)
        e_pop = 4 - torch.argmin(t_eff.flip(1), dim=1)
        pick = lambda a: a.gather(1, e_pop[:, None])[:, 0]
        tcol, j_pop, ctype = pick(t_eff), pick(slots.j), pick(slots.ctype)
        is_pair = ctype == INTER_AGENT
        # the iteration's one host sync: whether any game loops, and
        # whether any looping game pops a pair or a wall event (a fix-up
        # that no game takes is not computed: its result would be masked)
        any_active, any_pair, any_wall = torch.stack([
            active.any(), (active & is_pair).any(),
            (active & ~is_pair).any()]).tolist()
        if not any_active:
            break
        iters += active
        # the scored latch drops puck events without re-checking
        skip = ((e_pop == PUCK) | (is_pair & (j_pop == PUCK))) & scored
        live = active & ~skip

        if params.stochastic:
            rn, pn, sn = _iteration_draws(state.key, active, counter,
                                          params)
            # the puck's dynamics draw no noise
            ents_pre = torch.stack([e_pop, torch.where(is_pair, j_pop, 0)],
                                   dim=1)
            pmask = (ents_pre != PUCK).to(dtype)[:, None, :, None]
            rn, pn = (rn * pmask).unbind(1), (pn * pmask).unbind(1)
        else:
            rn = pn = sn = None

        # simulate the two involved entities up to t_col
        km1 = torch.clamp(torch.floor((tcol - t0) / dtcol), 0, G).to(
            torch.int64)
        base_new = km1 + 1
        e_j = torch.where(is_pair, j_pop, 0)
        ents = torch.stack([e_pop, e_j], dim=1)               # (B, 2)
        xs_m = grid[bi[:, None], km1[:, None], ents]           # (B, 2, 4)
        us = inputs[bi[:, None], ents]                         # (B, 2, 2)
        tau_p, drag_p = tau[ents][..., None], drag[ents][..., None]
        dt_t = (tcol - (t0 + km1.to(dtype) * dtcol))[:, None, None]
        xs_t = _rk4(xs_m, us, dt_t, dt_t / two, dt_t / six, tau_p, drag_p,
                    rn)
        r_i, r_j = radius[e_pop], radius[e_j]
        m_i, m_j = mass[e_pop], mass[e_j]
        rsum = r_i + r_j
        wall = _wall_terms(ctype, halfx, halfy, grid)

        # pair: de-penetrate (1.01), elastic impulse in the reference's
        # order  v1 - 2*m_j/(m_i+m_j) * dot/den * d12
        pos = _pair_overlap_correction(xs_t, rsum,
                                       _pair_coef(r_i, r_j, 1.01), zero)
        p_i, p_j = pos[:, 0, 0:2], pos[:, 1, 0:2]
        v1, v2 = xs_t[:, 0, 2:4], xs_t[:, 1, 2:4]
        d12 = p_i - p_j
        den = (d12 * d12).sum(-1)
        den_safe = torch.where(den > 0, den, 1.0)
        dv = v1 - v2
        dot_v = (dv * d12).sum(-1)
        msum = m_i + m_j
        c_i = 2.0 * m_j / msum * dot_v / den_safe
        c_j = 2.0 * m_i / msum * dot_v / den_safe
        xi_pair = torch.cat([p_i, v1 - c_i[:, None] * d12], dim=1)
        xj_pair = torch.cat([p_j, v2 - c_j[:, None] * (-d12)], dim=1)

        dmg_on = live & is_pair & (e_pop != PUCK) & (e_j != PUCK)
        dv2 = 0.01 * (dv * dv).sum(-1)
        di, dj = torch.clamp(e_pop, 0, 3), torch.clamp(e_j, 0, 3)
        flat = dmg.reshape(B, 16)
        flat = flat.scatter_add(1, (di * 4 + dj)[:, None],
                                torch.where(dmg_on, m_i * dv2, 0.0)[:, None])
        flat = flat.scatter_add(1, (dj * 4 + di)[:, None],
                                torch.where(dmg_on, m_j * dv2, 0.0)[:, None])
        dmg = flat.reshape(B, 4, 4)

        # wall: sign-conditioned flip, goal test (RIGHT -> team A)
        vx, vy = xs_t[:, 0, 2], xs_t[:, 0, 3]
        flip_y = ((ctype == 0) & (vy > 0)) | ((ctype == 1) & (vy < 0))
        flip_x = ((ctype == 2) & (vx > 0)) | ((ctype == 3) & (vx < 0))
        x_wall = torch.stack([xs_t[:, 0, 0], xs_t[:, 0, 1],
                              vx * torch.where(flip_x, -1.0, 1.0),
                              vy * torch.where(flip_y, -1.0, 1.0)], dim=1)
        py = xs_t[:, 0, 1]
        goal = (~is_pair & (e_pop == PUCK) & ((ctype == 2) | (ctype == 3))
                & (py < gh2) & (py > -gh2))
        fresh = goal & live & ~scored
        score = score + torch.stack([fresh & (ctype == 2),
                                     fresh & (ctype == 3)],
                                    dim=1).to(score.dtype)
        scored = scored | (goal & live)

        # the value at grid column base_new
        xres = torch.stack([torch.where(is_pair[:, None], xi_pair, x_wall),
                            xj_pair], dim=1)
        dt_r = dtcol - dt_t
        xprop = _rk4(xres, us, dt_r, dt_r / two, dt_r / six, tau_p, drag_p,
                     pn)
        pcoef = _pair_coef(r_i, r_j, buf)
        x_pair = _pair_overlap_correction(xprop, rsum, pcoef, zero)
        xi_base = torch.where(
            is_pair[:, None], x_pair[:, 0],
            torch.where(goal[:, None], 0.0, _wall_overlap_correction(
                xprop[:, 0], r_i, wall, buf, zero)))
        xj_base = x_pair[:, 1]
        # a base column past the grid (t_col rounding to t0 + dt) writes
        # nothing, as JAX drops an out-of-range scatter
        on_grid = live & (base_new <= G)
        bw = torch.clamp(base_new, max=G)
        cur = grid[bi, bw, e_pop]
        grid[bi, bw, e_pop] = torch.where(on_grid[:, None], xi_base, cur)
        cur = grid[bi, bw, e_j]
        grid[bi, bw, e_j] = torch.where((on_grid & is_pair)[:, None],
                                        xj_base, cur)

        # re-propagate the affected entities over the remaining columns
        # with per-column overlap fix-ups.  Columns up to every live game's
        # base are left as they are, so the loop starts after the smallest
        # base of the games it changes (the results are identical).
        start = int(torch.where(on_grid, base_new, G + 1).min()) + 1
        if start <= G:
            cols = torch.arange(start, G + 1, device=dev)
            m = on_grid[:, None] & (cols > base_new[:, None])  # (B, n)
            m_pair = (m & is_pair[:, None])[..., None]
            m_wall = (m & ~is_pair[:, None])[..., None]
            m_prop = torch.stack([m, m_pair[..., 0]], dim=2)[..., None]
            old = grid[bi[:, None, None], cols[None, :, None],
                       ents[:, None, :]]                   # (B, n, 2, 4)
            if sn is not None:
                sn = sn[bi[:, None], :, :, ents].permute(0, 2, 3, 1, 4)
            val = grid[bi[:, None], start - 1, ents]         # (B, 2, 4)
            out = []
            for i, c in enumerate(range(start, G + 1)):
                nz = None if sn is None else sn[:, c - 1].unbind(1)
                prop = _rk4(val, us, dtcol, dtcol2, dtcol6, tau_p, drag_p, nz)
                val = torch.where(m_prop[:, i], prop, old[:, i])
                if any_pair:
                    pair = _pair_overlap_correction(val, rsum, pcoef, zero)
                    pair = torch.where(m_pair[:, i, None], pair, val)
                else:
                    pair = val
                if any_wall:
                    row0 = torch.where(m_wall[:, i], _wall_overlap_correction(
                        val[:, 0], r_i, wall, buf, zero), pair[:, 0])
                    pair = torch.stack([row0, pair[:, 1]], dim=1)
                val = pair
                out.append(val)
            out = torch.stack(out, dim=1)                     # (B, n, 2, 4)
            # row 1 first: where e_j == e_pop (a wall event) it is unchanged
            grid[bi[:, None], cols, e_j[:, None]] = out[:, :, 1]
            grid[bi[:, None], cols, e_pop[:, None]] = out[:, :, 0]

        # slot bookkeeping: drop the events touching the affected
        # entities, re-detect only those
        touched = (ids == e_pop[:, None]) | (is_pair[:, None]
                                             & (ids == e_j[:, None]))
        aff = touched & live[:, None]
        j_touched = (((slots.j == e_pop[:, None])
                      | (is_pair[:, None] & (slots.j == e_j[:, None])))
                     & (slots.j >= 0))
        valid_kept = slots.valid & ~touched & ~j_touched
        redet = _detect(grid, base_new[:, None].expand(B, 5), t0, params,
                        radius)
        new = _Slots(t=torch.where(aff, redet.t, slots.t),
                     j=torch.where(aff, redet.j, slots.j),
                     ctype=torch.where(aff, redet.ctype, slots.ctype),
                     valid=torch.where(aff, redet.valid, valid_kept))
        # skip case: only the popped slot is invalidated
        pop_only = slots.valid & (ids != e_pop[:, None])
        valid = torch.where(skip[:, None], pop_only, new.valid)
        a1 = active[:, None]
        slots = _Slots(t=torch.where(a1, new.t, slots.t),
                       j=torch.where(a1, new.j, slots.j),
                       ctype=torch.where(a1, new.ctype, slots.ctype),
                       valid=torch.where(a1, valid, slots.valid))
        counter += 1

    # --- 3. commit the last grid column ------------------------------------
    new_keys = advance_keys(state.key) if params.stochastic else state.key
    return GameState(x=grid[:, G], score=score, damage=dmg,
                     t=t0 + params.dt, key=new_keys), iters
