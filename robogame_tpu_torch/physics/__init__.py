"""Physics of the port: dynamics, sub-step tables and noise, the sweep
engine, the event-order-exact step (K1) and the parallel-resolution step
(K6)."""

from .dynamics import rk4_step
from .parallel_step import parallel_step_plain
from .step import step_batch
from .sweep import step_sweep

__all__ = ["parallel_step_plain", "rk4_step", "step_batch", "step_sweep"]
