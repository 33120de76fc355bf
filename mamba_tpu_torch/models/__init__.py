"""Example models.  Each module exposes ``build() -> (model, inputs, inits,
...)`` with its sampling scheme pre-assigned."""

from . import glmm, line, rats

__all__ = ["glmm", "line", "rats"]
