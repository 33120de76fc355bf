"""Inference beyond MCMC:

- ``advi``: automatic differentiation variational inference — a mean-field
  Gaussian in the model's link-transformed space, used alone or as an MCMC
  warm start (ChEES-HMC's initialization contract).

The JAX package's ``smc`` is not ported yet.
"""

from .advi import ADVIResult, advi

__all__ = ["advi", "ADVIResult"]
