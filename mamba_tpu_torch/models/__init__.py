"""Example models.  Each module exposes ``build() -> (model, inputs, inits,
...)`` with its sampling scheme pre-assigned."""

from . import glmm

__all__ = ["glmm"]
