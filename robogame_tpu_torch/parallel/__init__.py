"""Batched Monte-Carlo sweeps."""

from .monte_carlo import McParams, McResult, aggregate, monte_carlo

__all__ = ["McParams", "McResult", "aggregate", "monte_carlo"]
