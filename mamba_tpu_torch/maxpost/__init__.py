"""MAP optimization (fork add-on, reference src/maxpost/maxpost.jl)."""

from .optim import MAPResult, optim_over

__all__ = ["optim_over", "MAPResult"]
