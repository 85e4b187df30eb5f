"""robogame_tpu_torch: the 2v2 air-hockey simulator in PyTorch and CUDA.

The batched Monte-Carlo game step runs on a hand-written CUDA kernel for
Hopper (``csrc/exact_step.cu``, K1), every batched QP of the classical
team and the CBF safety filter on a second one (``csrc/qp_admm.cu``, K2),
and every DMPC candidate's whole SQP on a third (``csrc/dmpc_sqp.cu``,
K3).
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.

    from robogame_tpu_torch import McParams, SimParams, monte_carlo
    res = monte_carlo(SimParams(engine="pallas_exact"), McParams(8192))

    # classical vs classical behind the CBF filter, 512 full games
    from robogame_tpu_torch import CbfParams, classical_matchup
    params = SimParams(dt=0.05, winning_score=4, engine="pallas_exact")
    policy, ps = classical_matchup(params, 512, cbf=CbfParams())
    res = monte_carlo(params, McParams(512, T=20.0, randomize_x0=True,
                                       x0_pos_range=(1.0, 0.5),
                                       x0_vel_range=2.0),
                      policy=policy, policy_state=ps)

    # DMPC vs DMPC (the reference's test_dmpc.py), 512 full games
    from robogame_tpu_torch import dmpc_matchup
    policy, ps = dmpc_matchup(params, 512, "dmpc")
"""

from .agents.dmpc_team import (DMPCPlayer, DMPCTeam, DmpcTeamState,
                               dmpc_matchup, dmpc_state_from_numpy,
                               dmpc_state_to_numpy)
from .agents.classical import (ClassicalTeam, PlayerState, TeamState,
                               classical_matchup, initial_team_state,
                               team_policy, team_policy_batch,
                               team_state_from_numpy, team_state_to_numpy)
from .config import (CbfParams, MpcParams, SimParams, StrategyParams,
                     resolve_device)
from .control.cbf import CbfResult, safe_control, safe_control_batch
from .control.dmpc import DmpcState, compute_control, compute_control_batch
from .control.trajopt import Trajectory, min_time_traj, min_time_traj_batch
from .ops.qp import QpSolution, solve_qp
from .ops.qp_lanes import solve_qp_lanes
from .ops.sqp_lanes import solve_dmpc_sqp_lanes, solve_dmpc_sqp_plain
from .parallel.monte_carlo import McParams, McResult, aggregate, monte_carlo
from .physics.exact_step import step_batch
from .state import (GameState, SimStateView, from_numpy, from_vector,
                    initial_state, to_numpy, to_vector, undecided)

__all__ = [
    "CbfParams", "CbfResult", "ClassicalTeam", "DMPCPlayer", "DMPCTeam",
    "DmpcState", "DmpcTeamState", "GameState", "McParams", "McResult",
    "MpcParams", "PlayerState", "QpSolution", "SimParams", "SimStateView",
    "StrategyParams", "TeamState", "Trajectory", "aggregate",
    "classical_matchup", "compute_control", "compute_control_batch",
    "dmpc_matchup", "dmpc_state_from_numpy", "dmpc_state_to_numpy",
    "from_numpy", "from_vector", "initial_state", "initial_team_state",
    "min_time_traj", "min_time_traj_batch", "monte_carlo", "resolve_device",
    "safe_control", "safe_control_batch", "solve_dmpc_sqp_lanes",
    "solve_dmpc_sqp_plain", "solve_qp", "solve_qp_lanes", "step_batch",
    "team_policy", "team_policy_batch", "team_state_from_numpy",
    "team_state_to_numpy", "to_numpy", "to_vector", "undecided",
]
