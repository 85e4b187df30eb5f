"""Batched Monte-Carlo sweeps, sharded over a mesh of processes."""

from .mesh import (BATCH_AXIS, batch_sharding, init_distributed, make_mesh,
                   replicated, shard_batch)
from .monte_carlo import McParams, McResult, aggregate, monte_carlo

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch",
           "init_distributed", "BATCH_AXIS", "McParams", "McResult",
           "monte_carlo", "aggregate"]
