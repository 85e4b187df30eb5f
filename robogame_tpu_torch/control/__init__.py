"""Controllers: trajectory optimizers, the CBF safety filter and the MPCs
(CMPC, DMPC, the puck player), with the exact obstacle MIQP."""

from .trajopt import (Trajectory, intercepting_traj,
                      min_time_bounce_kick_traj, min_time_traj)
from .obstacles import (intercepting_with_obs_avoidance,
                        intercepting_with_obs_avoidance_bb,
                        min_time_traj_avoid_obs)
from .contact import BouncePlan, bounce_pass_wall
from .cbf import CbfResult, safe_control, safe_control_batch
from . import cmpc, dmpc, miqp, puck_player_mpc

__all__ = [
    "Trajectory", "intercepting_traj", "min_time_traj",
    "min_time_bounce_kick_traj", "intercepting_with_obs_avoidance",
    "intercepting_with_obs_avoidance_bb", "min_time_traj_avoid_obs",
    "BouncePlan", "bounce_pass_wall", "CbfResult", "safe_control",
    "safe_control_batch", "cmpc", "dmpc", "miqp", "puck_player_mpc",
]
