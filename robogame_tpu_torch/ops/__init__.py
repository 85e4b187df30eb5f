"""Batched QP solvers: the plain ADMM (ops.qp) and its CUDA kernel
K2 behind ops.qp_lanes."""
