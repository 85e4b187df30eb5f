"""robogame_tpu_torch: the 2v2 air-hockey simulator in PyTorch and CUDA.

The batched Monte-Carlo game step runs on a hand-written CUDA kernel for
Hopper (``csrc/exact_step.cu``); every entry point runs on ``cuda`` unless
the caller passes ``device="cpu"``, which runs the plain PyTorch version of
the same step.

    from robogame_tpu_torch import McParams, SimParams, monte_carlo
    res = monte_carlo(SimParams(engine="pallas_exact"), McParams(8192))
"""

from .config import (CbfParams, MpcParams, SimParams, StrategyParams,
                     resolve_device)
from .parallel.monte_carlo import McParams, McResult, aggregate, monte_carlo
from .physics.exact_step import step_batch
from .state import (GameState, SimStateView, from_numpy, from_vector,
                    initial_state, to_numpy, to_vector, undecided)

__all__ = [
    "CbfParams", "GameState", "McParams", "McResult", "MpcParams",
    "SimParams", "SimStateView", "StrategyParams", "aggregate",
    "from_numpy", "from_vector", "initial_state", "monte_carlo",
    "resolve_device", "step_batch", "to_numpy", "to_vector", "undecided",
]
