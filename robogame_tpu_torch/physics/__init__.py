"""Physics of the port: dynamics, sub-step tables and noise, the event
engine, the sweep engine, the event-order-exact step (K1), the
parallel-resolution step (K6), the activity-sorted rollout, and the
rollouts."""

from .dynamics import (entity_consts, exact_player_step, exact_puck_step,
                       rk4_step)
from .parallel_step import parallel_step_plain
from .rollout import (LogRecord, batch_rollout, log_record, rollout,
                      scripted_rollout)
from .step import rollout_pallas_sorted, step, step_batch
from .sweep import step_sweep

__all__ = ["LogRecord", "batch_rollout", "entity_consts",
           "exact_player_step", "exact_puck_step", "log_record",
           "parallel_step_plain", "rk4_step", "rollout",
           "rollout_pallas_sorted", "scripted_rollout", "step",
           "step_batch", "step_sweep"]
