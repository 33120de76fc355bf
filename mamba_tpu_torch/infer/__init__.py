"""Inference beyond MCMC:

- ``advi``: automatic differentiation variational inference — a mean-field
  Gaussian in the model's link-transformed space, used alone or as an MCMC
  warm start (ChEES-HMC's initialization contract).
- ``smc``: likelihood-tempered sequential Monte Carlo with systematic
  resampling and random-walk rejuvenation, the particles one batch axis.
"""

from .advi import ADVIResult, advi
from .smc import SMCResult, smc

__all__ = ["advi", "ADVIResult", "smc", "SMCResult"]
