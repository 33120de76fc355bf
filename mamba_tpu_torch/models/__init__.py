"""Example model zoo (reference doc/tutorial + doc/examples BUGS volumes):
the models whose nodes are univariate, discrete or ``Mixed``.

Each module exposes ``build() -> (model, inputs, inits)`` with the
reference's sampling scheme pre-assigned, and ``GOLDEN``, the published
posterior means it reproduces."""

from . import (blocker, bones, dogs, dyes, epil, equiv, glmm, inhalers,
               kidney, leuk, line, lsat, magnesium, mice, oxford, pumps, rats,
               salm, seeds, stacks, surgical)

__all__ = ["blocker", "bones", "dogs", "dyes", "epil", "equiv", "glmm",
           "inhalers", "kidney", "leuk", "line", "lsat", "magnesium", "mice",
           "oxford", "pumps", "rats", "salm", "seeds", "stacks", "surgical"]
