"""Batched QP solvers: the plain ADMM (ops.qp) and its CUDA kernel
K2 behind ops.qp_lanes; the LTI horizon forms of the player models."""

from ..models.lqsys import condense, euler_ab, exact_ab, exact_puck_ab
from .qp import QpSolution, solve_qp, solve_qp_batch

__all__ = ["QpSolution", "solve_qp", "solve_qp_batch", "condense",
           "euler_ab", "exact_ab", "exact_puck_ab"]
