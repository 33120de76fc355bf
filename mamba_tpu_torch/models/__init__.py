"""Example model zoo (reference doc/tutorial and the doc/examples BUGS
volumes): all 28 models of the JAX package.

Each module exposes ``build() -> (model, inputs, inits)`` with the
reference's sampling scheme pre-assigned, and ``GOLDEN``, the published
posterior means it reproduces (``glmm`` and ``rats`` take arguments of their
own and ``pollution`` a scheme)."""

from . import (asthma, birats, blocker, bones, dogs, dyes, epil, equiv, eyes,
               gk, glmm, inhalers, jaws, kidney, leuk, line, line_abc, lsat,
               magnesium, mice, oxford, pollution, pumps, rats, salm, seeds,
               stacks, surgical)

__all__ = ["asthma", "birats", "blocker", "bones", "dogs", "dyes", "epil",
           "equiv", "eyes", "gk", "glmm", "inhalers", "jaws", "kidney",
           "leuk", "line", "line_abc", "lsat", "magnesium", "mice", "oxford",
           "pollution", "pumps", "rats", "salm", "seeds", "stacks",
           "surgical"]
