"""robogame_tpu_torch: the 2v2 air-hockey simulator in PyTorch and CUDA.

The batched Monte-Carlo game step runs on a hand-written CUDA kernel for
Hopper (``csrc/exact_step.cu``, K1), every batched QP of the classical
team and the CBF safety filter on a second one (K2: ``csrc/qp_grouped.cu``
for the skills' QPs, which share their operands, ``csrc/qp_admm.cu`` for
the rest),
every DMPC candidate's whole SQP on a third (``csrc/dmpc_sqp.cu``, K3),
and every CMPC candidate's joint SQP on a fourth (``csrc/cmpc_sqp.cu``,
K4), with the structured joint QP of the CMPC "joint" route on a fifth
(``csrc/qp_joint.cu``, K5).
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

    # CMPC vs CMPC (the reference's bl_vs_bl), DMPC vs CMPC
    from robogame_tpu_torch import cmpc_matchup
    policy, ps = cmpc_matchup(params, 512)
    policy, ps = dmpc_matchup(params, 512, "cmpc")
"""

from .agents.centralized import (BaselineCentralizedPlayers,
                                 CentralizedTeam, cmpc_matchup,
                                 cmpc_state_from_numpy, cmpc_state_to_numpy)
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
from .control.cmpc import CmpcState, initial_cmpc_state
from .control.dmpc import DmpcState, compute_control, compute_control_batch
from .control.trajopt import Trajectory, min_time_traj, min_time_traj_batch
from .ops.qp import QpSolution, solve_qp
from .ops.qp_lanes import (solve_qp_lanes, solve_qp_lanes_joint,
                           solve_qp_lanes_joint_plain)
from .ops.sqp_lanes import (solve_cmpc_sqp_lanes, solve_cmpc_sqp_plain,
                            solve_dmpc_sqp_lanes, solve_dmpc_sqp_plain)
from .parallel.monte_carlo import McParams, McResult, aggregate, monte_carlo
from .physics.parallel_step import parallel_step_plain
from .physics.step import step_batch
from .physics.sweep import step_sweep
from .state import (GameState, SimStateView, from_numpy, from_vector,
                    initial_state, to_numpy, to_vector, undecided)

__all__ = [
    "BaselineCentralizedPlayers", "CbfParams", "CbfResult", "CentralizedTeam",
    "ClassicalTeam", "CmpcState", "DMPCPlayer", "DMPCTeam", "DmpcState",
    "DmpcTeamState", "GameState", "McParams", "McResult", "MpcParams",
    "PlayerState", "QpSolution", "SimParams", "SimStateView", "StrategyParams",
    "TeamState", "Trajectory", "aggregate", "classical_matchup",
    "cmpc_matchup", "cmpc_state_from_numpy", "cmpc_state_to_numpy",
    "compute_control", "compute_control_batch", "dmpc_matchup",
    "dmpc_state_from_numpy", "dmpc_state_to_numpy", "from_numpy",
    "from_vector", "initial_cmpc_state", "initial_state", "initial_team_state",
    "min_time_traj", "min_time_traj_batch", "monte_carlo",
    "parallel_step_plain", "resolve_device",
    "safe_control", "safe_control_batch", "solve_cmpc_sqp_lanes",
    "solve_cmpc_sqp_plain", "solve_dmpc_sqp_lanes", "solve_dmpc_sqp_plain",
    "solve_qp", "solve_qp_lanes", "solve_qp_lanes_joint",
    "solve_qp_lanes_joint_plain", "step_batch", "step_sweep", "team_policy",
    "team_policy_batch", "team_state_from_numpy", "team_state_to_numpy",
    "to_numpy", "to_vector", "undecided",
]
