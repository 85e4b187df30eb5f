"""The yardstick of the kernels' rooflines: the published peaks of one
NVIDIA H100 and the bytes and operations each kernel's problem needs,
counted from the problem's shapes and the configuration's fixed iteration
counts only, never from how a kernel is written, so that a share reads the
same work whatever implements it later.  A bound is the larger of the
bytes over the peak bandwidth and the operations over the peak f32 rate;
a share is the bound over the measured device time.

The counts are frozen copies of ``chip_smoke.py``'s arithmetic (K1's
bytes, ``k3_flops``, ``k4_flops``); the rates are those of the data sheet,
at a power limit of 700 W: ``power_limit()`` reads the card's.
"""

from __future__ import annotations

import subprocess

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12              # f32 outside the tensor cores


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``"not read"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_PER_S)


# ---- K1: one event-order-exact control step of B games -----------------

def k1_bytes(B: int, grid_points: int) -> float:
    """Each game's state and controls read once and its state written
    once, f32: x (20), controls (8), score (2), time (1), damage (16) in;
    x, score, time, damage out; and the populate's table (20 components x
    (G + 1) columns x 6 non-zeros) once."""
    per_game = (20 + 8 + 2 + 1 + 16) + (20 + 2 + 1 + 16)
    return 4.0 * (B * per_game + 20 * (grid_points + 1) * 6)


def k1_flops(B: int, grid_points: int) -> float:
    """A lower count of the operations: the populate of the sub-step grid
    (6 products and 5 sums a cell, 20 components x (G + 1) columns); the
    detect and the events, whose number depends on the play, are not
    counted."""
    return 11.0 * 20 * (grid_points + 1) * B


def k1_bound_s(B: int, grid_points: int) -> float:
    return bound_s(k1_bytes(B, grid_points), k1_flops(B, grid_points))


# ---- K3: the fused DMPC SQP, P single-agent problems --------------------

def k3_flops(n1, m, M, N, n_seg0, it0, sqp_rest, it_rest):
    """The f32 operations of one DMPC SQP solve on its knot-structured
    algebra (the constraint rows are the position sensitivities' knot rows,
    so A'A, A x and A'y go through them): the gram terms once; per
    relinearization Y = SG x and the keepout rows' scales, bounds and
    coefficients, per warm one the dual rescale and the reseed; per
    segment the knots' 2 x 2 blocks Q, V = Q SG and the lower triangle of
    K = H + rho SG'V + diag, the Cholesky factor and its inverse (n1^3 / 3
    each) and the residuals (H x, A'y as SG'u); per iteration the fold of
    the rows into u, SG'u, C r, C't, SG x and the updates of the own and
    the box rows.  Every loop count is fixed."""
    tri = n1 * (n1 + 1) // 2
    gram = 6 * N * n1
    relin = 4 * N * n1 + 2 * N + 25 * M * N
    warm = 5 * M * N + 2 * N
    seg = (6 * M + 2) * N + 6 * N * n1 + 4 * N * tri + 2 * tri + n1 + \
        2 * n1 ** 3 // 3 + 2 * n1 * n1 + 4 * N * n1 + 6 * m + 5 * (m + n1)
    it = 8 * N * n1 + 2 * n1 * (n1 + 1) + 19 * m + 15 * n1
    return gram + (1 + sqp_rest) * relin + sqp_rest * warm + \
        (n_seg0 + sqp_rest) * seg + (n_seg0 * it0 + sqp_rest * it_rest) * it


def k3_bytes(P: int, N: int, M: int) -> float:
    """Each input read once (H, g, the sensitivities, the free positions,
    the obstacles, the arena and box bounds, the start) and x with its 5
    statistics written once, f32."""
    n1 = 2 * N
    ins = n1 * n1 + n1 + N * 2 * n1 + N * 2 + M * 2 + 2 * (2 * N) + 3 * n1
    return 4.0 * P * (ins + n1 + 5)


# ---- K4: the fused joint CMPC SQP, P two-player problems ----------------

def k4_flops(n1, mo, mp, M, N, n_seg0, it0, sqp_rest, it_rest):
    """The f32 operations of one joint CMPC SQP solve on its
    knot-structured algebra: the gram terms once; per relinearization both
    players' Y = SG x, the keepout and pair rows' scales, bounds and
    coefficients, per warm one the dual rescale and the reseed; per
    segment K11 and K22 as H + rho SG'V (V = Q SG), K12 as N rank-1 terms,
    W = C1 K12, S = K22 - W'W, two Cholesky factors and their inverses, the
    residuals; per iteration the fold into u, SG'u and SG x for both
    players, the six products of the Schur solve and the row and box
    updates.  Every loop count is fixed."""
    R = 2 * mo + mp
    tri = n1 * (n1 + 1) // 2
    gram = 12 * N * n1
    relin = 2 * (4 * N * n1 + 2 * N + 25 * M * N) + 30 * N
    warm = 2 * (5 * M * N + 2 * N) + 5 * N
    seg = 2 * (6 * M + 8) * N + 2 * (6 * N * n1 + 4 * N * tri + 2 * tri +
                                     n1) + \
        2 * N * n1 * n1 + 6 * N * n1 + n1 * n1 + n1 * n1 * (n1 + 1) + \
        2 * n1 * tri + 4 * n1 ** 3 // 3 + \
        4 * n1 * n1 + 8 * N * n1 + 4 * R + 5 * (R + 2 * n1)
    it = 6 * R + 16 * N * n1 + 4 * n1 * (n1 + 1) + 4 * n1 * n1 + 2 * n1 + \
        3 * (2 * M * N + mp) + 10 * R + 30 * n1
    return gram + (1 + sqp_rest) * relin + sqp_rest * warm + \
        (n_seg0 + sqp_rest) * seg + (n_seg0 * it0 + sqp_rest * it_rest) * it


def k4_bytes(P: int, N: int, M: int) -> float:
    """Each input read once (both Hessian blocks, g, both players'
    sensitivities and free positions, the obstacles, the arena and box
    bounds, the start) and x with its 5 statistics written once, f32."""
    n1 = 2 * N
    ins = 2 * n1 * n1 + 2 * n1 + 2 * N * 2 * n1 + 2 * N * 2 + M * 2 + \
        2 * 2 * (2 * N) + 3 * 2 * n1
    return 4.0 * P * (ins + 2 * n1 + 5)


def sqp_counts(mpc: dict) -> dict:
    """The SQP schedule the configuration fixes: 4 cold segments of
    qp_iters / 4 iterations, then sqp_iters - 1 warm segments of
    warm_qp_iters."""
    return {"n_seg0": 4, "it0": max(1, mpc["qp_iters"] // 4),
            "sqp_rest": mpc["sqp_iters"] - 1, "it_rest": mpc["warm_qp_iters"]}


def k3_bound_s(P: int, mpc: dict, M: int = 3) -> float:
    N = mpc["N"]
    flops = P * k3_flops(2 * N, (2 + M) * N, M, N, **sqp_counts(mpc))
    return bound_s(k3_bytes(P, N, M), flops)


def k4_bound_s(P: int, mpc: dict, M: int = 2) -> float:
    N = mpc["N"]
    flops = P * k4_flops(2 * N, (2 + M) * N, N, M, N, **sqp_counts(mpc))
    return bound_s(k4_bytes(P, N, M), flops)
