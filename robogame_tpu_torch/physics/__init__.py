"""Physics of the port: dynamics, sub-step tables and noise, and the
event-order-exact batched step (K1)."""

from .dynamics import rk4_step
from .exact_step import step_batch

__all__ = ["rk4_step", "step_batch"]
