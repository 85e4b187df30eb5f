"""Frozen configuration dataclasses for the PyTorch/CUDA port.

Field for field the same as the JAX package's ``config.py`` so that a
configuration carries across unchanged; only ``jdtype`` becomes
:attr:`SimParams.torch_dtype`.  ``engine`` keeps its string values; the
port's step implements ``"pallas_exact"`` (the event-order-exact step, run
by the hand-written CUDA kernel in ``csrc/exact_step.cu``) and raises
``NotImplementedError`` for the others.

Entry points run on ``cuda`` unless the caller asks for the CPU
(:func:`resolve_device`); without a card they raise instead of silently
running on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Entity index order: 0 = A1, 1 = A2, 2 = B1, 3 = B2, 4 = PUCK
A1, A2, B1, B2, PUCK = 0, 1, 2, 3, 4
N_ENTITIES = 5
N_PLAYERS = 4

# Collision type ids
WALL_UP, WALL_DOWN, WALL_RIGHT, WALL_LEFT, INTER_AGENT = 0, 1, 2, 3, 4

# State component order within an entity's 4-vector: [px, py, vx, vy]
PX, PY, VX, VY = 0, 1, 2, 3

# Flat 22-vector layout of the reference state:
#   [scoreA, scoreB, puck(4), A1(4), A2(4), B1(4), B2(4)]
VEC_TAS, VEC_TBS, VEC_PK, VEC_A1, VEC_A2, VEC_B1, VEC_B2, VEC_SIZE = (
    0, 1, 2, 6, 10, 14, 18, 22)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Asking for ``cuda`` on a machine without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "robogame_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Physics parameters; defaults equal the reference C++ defaults."""

    dt: float = 0.05
    winning_score: int = 3
    noise: float = 0.0                 # w_stdev on player accelerations
    tau_player: float = 0.5
    tau_puck: float = 0.1
    player_mass: float = 1.0
    puck_mass: float = 0.5
    player_radius: float = 0.2
    puck_radius: float = 0.175
    arena_x: float = 10.0
    arena_y: float = 5.0
    goal_height: float = 1.0
    input_limit: float = 10.0
    # Sub-step grid / event loop
    grid_points: int = 50
    collision_counter_lim: int = 50
    overlap_buffer: float = 1.1
    # Numerics
    dtype: str = "float32"
    stochastic: bool = False
    # "event" | "sweep" | "pallas" | "pallas_exact"; the port's step runs
    # "pallas_exact" (event-order-exact: one globally-earliest event per
    # game per loop iteration, sequential feedback re-propagation)
    engine: str = "event"
    sweep_iters: int = 50
    # Two-phase event loop: phase 1 runs every game to phase1_iters
    # events, the games still pending are compacted into B/compact_frac
    # lanes and finished at full depth (a full-batch resume runs instead
    # when more games are pending), so two-phase equals one-phase.
    two_phase: bool = True
    phase1_iters: int = 1
    compact_frac: int = 16

    def __post_init__(self):
        if self.engine not in ("event", "sweep", "pallas", "pallas_exact"):
            raise ValueError(
                f"SimParams.engine must be 'event', 'sweep', 'pallas' or "
                f"'pallas_exact', got {self.engine!r}")
        if self.two_phase and not 0 < self.phase1_iters < self.sweep_iters:
            raise ValueError(
                "two_phase needs 0 < phase1_iters < sweep_iters, got "
                f"{self.phase1_iters} / {self.sweep_iters}")

    @property
    def dt_col(self) -> float:
        return self.dt / self.grid_points

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def radii(self) -> Tuple[float, ...]:
        r, p = self.player_radius, self.puck_radius
        return (r, r, r, r, p)

    @property
    def masses(self) -> Tuple[float, ...]:
        m, q = self.player_mass, self.puck_mass
        return (m, m, m, m, q)

    @property
    def taus(self) -> Tuple[float, ...]:
        return (self.tau_player,) * 4 + (self.tau_puck,)

    @property
    def drags(self) -> Tuple[float, ...]:
        # Player: vdot = (u - v)/tau; puck: vdot = (u - 0.2 v)/tau
        return (1.0, 1.0, 1.0, 1.0, 0.2)

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MpcParams:
    """Horizon / weight parameters shared by the MPC controllers."""

    N: int = 20
    minT_frac: float = 1.0
    maxT: float = 5.0 / 20.0
    w_pos: float = 10.0
    w_vel: float = 20.0
    u_reg: float = 1e-2
    sqp_iters: int = 6
    qp_iters: int = 150
    warm_qp_iters: int = 40
    t_grid: int = 8
    t_local: int = 4

    def replace(self, **kw) -> "MpcParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CbfParams:
    """CBF safety-filter parameters."""

    safety_radius: float = 0.4
    barrier_gain: float = 30.0
    qp_iters: int = 50

    def replace(self, **kw) -> "CbfParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class StrategyParams:
    """Team strategy thresholds."""

    kick_velocity: float = 4.0
    v_hit: float = 4.0
    v_thresh: float = 1.0
    d_goalie_offense: float = 5.0
    d_goalie_defense: float = 2.5

    def replace(self, **kw) -> "StrategyParams":
        return dataclasses.replace(self, **kw)
