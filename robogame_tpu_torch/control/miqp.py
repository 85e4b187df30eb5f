"""Exact MIQP obstacle avoidance: branch and bound over the big-M side
binaries.

Counterpart of the JAX package's ``control/miqp.py`` (the reference's
``intercepting_with_obs_avoidance_bb`` under Drake's
MixedIntegerBranchAndBound): effort-only objective ``sum_k |u_k|^2``,
terminal *equality* to ``xf``, input and arena boxes, and for each knot k
and obstacle o the axis-separation disjunction (one of ``p_x >= o_x + s``,
``p_x <= o_x - s``, ``p_y >= o_y + s``, ``p_y <= o_y - s``), i.e. the
keep-out region is the l-inf box of half-width ``s``.

The search stays on the host, best-first on a heap.  Each batch of up to
``batch`` frontier nodes is one batched :func:`..ops.qp.solve_qp` on the
caller's device in the params' dtype: the node rows are those of
:func:`.obstacles._solve_sides` with the node's side codes, where a free
pair drops its disjunction (a valid lower bound).  Branching fixes each
of the four sides of the most violated (obstacle, knot) pair.
:func:`.obstacles.intercepting_with_obs_avoidance_bb` stays the fast
incumbent; this module gives the exact optimum and the optimality gap.
"""

from __future__ import annotations

import heapq
import itertools

import numpy as np
import torch

from ..config import SimParams, resolve_device
from .obstacles import _build_parts, _solve_sides
from .trajopt import MAX_TRAJ, Trajectory, _vec

# side codes per (obstacle, knot) pair
FREE, XMIN, XMAX, YMIN, YMAX = -1, 0, 1, 2, 3


def _solve_nodes(sides, x0, xf, obs, obs_s, obs_mask, params: SimParams,
                 N: int, qp_iters: int = 250):
    """Solve node relaxations in one batch.  ``sides``: (B, M, N) int64 in
    {-1 free, 0..3 fixed side}.  Returns per node: U (B, 2N), the effort
    objective, the converged flag, the final primal residual, and the knot
    positions (B, N, 2)."""
    parts = _build_parts(x0, xf, params.dt, params, N, 0.0, 1.0, True)
    sol = _solve_sides(sides, parts, x0, obs, obs_s, obs_mask, qp_iters)
    sel_gam = (parts.sel @ parts.gam).reshape(N, 2, -1)
    p0_part = (parts.sel @ (parts.phi @ x0)).reshape(N, 2)
    p = p0_part + torch.einsum("ncu,bu->bnc", sel_gam, sol.x)
    return sol.x, (sol.x * sol.x).sum(-1), sol.converged, sol.prim_res, p


def _violations(p, obs, obs_s, obs_mask):
    """l-inf keep-out violation per (m, k): s - max(|dx|, |dy|), > 0 where
    the knot lies inside the box."""
    d = np.abs(p[None, :, :] - obs[:, None, :])             # (M, N, 2)
    v = obs_s[:, None] - d.max(axis=-1)
    return np.where(obs_mask[:, None], v, -1.0)


def _problem(p0, v0, pf, vf, obs, obs_s, obs_mask, params, device):
    dev = resolve_device(device)
    dtype = params.torch_dtype
    x0 = torch.cat([_vec(p0, dtype, dev), _vec(v0, dtype, dev)])
    xf = torch.cat([_vec(pf, dtype, dev), _vec(vf, dtype, dev)])
    return (x0, xf, torch.as_tensor(np.asarray(obs), dtype=dtype).to(dev),
            torch.as_tensor(np.asarray(obs_s), dtype=dtype).to(dev),
            torch.as_tensor(np.asarray(obs_mask), dtype=torch.bool).to(dev),
            dev)


def solve_bb_exact(p0, v0, pf, vf, obs, obs_s, obs_mask,
                   params: SimParams, n_steps: int,
                   qp_iters: int = 250, feas_tol: float = 2e-3,
                   gap_tol: float = 1e-4, max_nodes: int = 4096,
                   batch: int = 16, bound_eps: float = 1e-3,
                   device="cuda"):
    """Best-first branch and bound to the MIQP optimum (up to the node
    QPs' accuracy), node QPs on ``device``.  Returns ``(Trajectory,
    info)`` with ``info['nodes']``, ``info['objective']``,
    ``info['lower_bound']`` and ``info['status']`` ("optimal",
    "node_limit" or "infeasible_x0").

    An unconverged node relaxation is not proof of infeasibility: such a
    node is solved once more at 4x ``qp_iters`` before its subtree is
    pruned.  The ADMM objective is inexact, so a node's lower bound
    carries the margin ``f (1 - bound_eps) - bound_eps`` when it prunes."""
    x0, xf, obs_t, s_t, mask_t, dev = _problem(p0, v0, pf, vf, obs, obs_s,
                                               obs_mask, params, device)
    N, M = int(n_steps), int(obs_t.shape[0])
    obs_np = np.asarray(obs, float)
    s_np = np.asarray(obs_s, float)
    mask_np = np.asarray(obs_mask, bool)

    # knot 0 is pinned to x0: if x0 itself violates a keep-out the MIQP is
    # infeasible (the reference raises; this returns success=False)
    v0_viol = _violations(np.asarray(p0, float)[None], obs_np, s_np,
                          mask_np)
    if (v0_viol > feas_tol).any():
        return _pack_host(np.zeros(2 * N), N, params, False, dev), dict(
            nodes=0, objective=np.inf, lower_bound=np.inf,
            status="infeasible_x0")

    def solve_batch(sides_list, iters=qp_iters):
        sides = torch.as_tensor(np.stack(sides_list), dtype=torch.int64)
        out = _solve_nodes(sides.to(dev), x0, xf, obs_t, s_t, mask_t,
                           params, N, iters)
        return tuple(a.cpu().numpy() for a in out)

    root = np.full((M, N), FREE, np.int64)
    heap = [(0.0, 0, root)]          # (lower bound, tiebreak, sides)
    tie = itertools.count(1)
    best_f = np.inf
    best_U = None
    n_solved = 0
    while heap and n_solved < max_nodes:
        todo = []
        while heap and len(todo) < batch:
            lb, _, sides = heapq.heappop(heap)
            if lb >= best_f - gap_tol:
                continue
            todo.append((lb, sides))
        if not todo:
            break
        U, f, conv, prim, p = solve_batch([s for _, s in todo])
        n_solved += len(todo)
        # re-solve unconverged nodes at 4x the iterations before pruning: a
        # feasible but slowly converging relaxation must not kill a subtree
        # that may hold the optimum
        bad = [i for i in range(len(todo))
               if not conv[i] and prim[i] > 1e-2]
        if bad:
            U2, f2, conv2, prim2, p2 = solve_batch(
                [todo[i][1] for i in bad], iters=4 * qp_iters)
            n_solved += len(bad)
            for bi, i in enumerate(bad):
                U[i], f[i], p[i] = U2[bi], f2[bi], p2[bi]
                conv[i], prim[i] = conv2[bi], prim2[bi]
        for i, (lb_parent, sides) in enumerate(todo):
            if not conv[i] and prim[i] > 1e-2:
                continue  # still infeasible at 4x iterations: prune
            node_lb = max(float(f[i]) * (1.0 - bound_eps) - bound_eps,
                          lb_parent)
            if node_lb >= best_f - gap_tol:
                continue
            viol = _violations(p[i], obs_np, s_np, mask_np)
            # pairs already fixed are enforced by the QP
            viol = np.where(sides >= 0, -1.0, viol)
            worst = np.unravel_index(np.argmax(viol), viol.shape)
            if viol[worst] <= feas_tol:
                # the relaxation already satisfies every disjunction
                if conv[i] and f[i] < best_f:
                    best_f, best_U = float(f[i]), U[i]
                continue
            for side in (XMIN, XMAX, YMIN, YMAX):
                child = sides.copy()
                child[worst] = side
                heapq.heappush(heap, (node_lb, next(tie), child))
    lb_rem = min([h[0] for h in heap], default=best_f)
    info = dict(nodes=n_solved, objective=best_f,
                lower_bound=min(best_f, lb_rem),
                status="optimal" if not heap else "node_limit")
    ok = best_U is not None
    return _pack_host(best_U if ok else np.zeros(2 * N), N, params, ok,
                      dev), info


def solve_enumerate(p0, v0, pf, vf, obs, obs_s, obs_mask,
                    params: SimParams, n_steps: int, qp_iters: int = 250,
                    chunk: int = 256, device="cuda"):
    """Brute-force ground truth for tiny instances: the QP of every
    complete side assignment (4^(M_active N)), ``chunk`` a batch on
    ``device``; returns the best feasible objective.  An oracle for
    :func:`solve_bb_exact`."""
    x0, xf, obs_t, s_t, mask_t, dev = _problem(p0, v0, pf, vf, obs, obs_s,
                                               obs_mask, params, device)
    N, M = int(n_steps), int(obs_t.shape[0])
    pairs = [(m, k) for m in range(M) if np.asarray(obs_mask)[m]
             for k in range(N)]
    best = np.inf
    for start in range(0, 4 ** len(pairs), chunk):
        codes = range(start, min(start + chunk, 4 ** len(pairs)))
        sides = np.full((len(codes), M, N), FREE, np.int64)
        for j, c in enumerate(codes):
            for (m, k) in pairs:
                sides[j, m, k] = c % 4
                c //= 4
        _, f, conv, prim, _ = _solve_nodes(
            torch.as_tensor(sides).to(dev), x0, xf, obs_t, s_t, mask_t,
            params, N, qp_iters)
        ok = conv & (prim < 1e-3)
        if bool(ok.any()):
            best = min(best, float(f[ok].min()))
    return best


def _pack_host(U, N: int, params: SimParams, success: bool,
               device) -> Trajectory:
    """A host solution as the port's :class:`Trajectory` on ``device``."""
    u = np.zeros((2, MAX_TRAJ))
    if success:
        u[:, :N] = np.asarray(U).reshape(N, 2).T
    dev = resolve_device(device)
    return Trajectory(
        u=torch.as_tensor(u, dtype=params.torch_dtype).to(dev),
        length=torch.tensor(N if success else 1, dtype=torch.int32,
                            device=dev),
        success=torch.tensor(success, device=dev),
        T=torch.tensor(N * params.dt, dtype=params.torch_dtype,
                       device=dev))
