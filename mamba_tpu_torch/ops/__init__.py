"""Tensor operations: bijectors, distributions and the fused GLMM kernel."""
