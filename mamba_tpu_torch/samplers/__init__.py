"""Sampler kernels (reference src/samplers/): each exposes stand-alone
functions ``<name>_init`` / ``<name>_step`` on chain-stacked vectors plus an
engine-facing ``SamplerSpec`` subclass binding the kernel to a block of
model nodes."""

from .base import (BlockKernel, SamplerSpec, metropolis_accept, validate,
                   validatebinary, validatesimplex)
from .abc import ABC, ABCTune
from .binary import (BHMC, BHMCTune, BIA, BIATune, BMC3, BMC3Tune, BMG,
                     BMGTune, bhmc_init, bhmc_step, bia_init, bia_step,
                     bmc3_init, bmc3_step, bmg_init, bmg_step)
from .custom import Gibbs
from .amm import (AMM, AMMTune, amm_adapt, amm_init, amm_propose, amm_step)
from .amwg import AMWG, AMWGTune, amwg_init, amwg_step
from .chees import ChEESHMC, ChEESTune, chees_init, chees_step
from .dgs import DGS, DGSTune, dgs_step, dgs_support, discrete_step
from .hmc import HMC, HMCTune, hmc_init, hmc_step
from .mala import MALA, MALATune, mala_init, mala_step
from .miss import MISS, missing_masks
from .nuts import NUTS, NUTSTune, nuts_init, nuts_step, nutsepsilon
from .rwm import RWM, RWMTune, rwm_init, rwm_step
from .slice import (Slice, SliceTune, slice_init, slice_multivariate_step,
                    slice_univariate_step)
from .slicesimplex import (SliceSimplex, SliceSimplexTune, slicesimplex_init,
                           slicesimplex_step)

__all__ = ["BlockKernel", "SamplerSpec", "metropolis_accept", "Gibbs",
           "validate", "validatebinary", "validatesimplex",
           "ABC", "ABCTune",
           "BHMC", "BHMCTune", "BIA", "BIATune", "BMC3", "BMC3Tune", "BMG",
           "BMGTune", "bhmc_init", "bhmc_step", "bia_init", "bia_step",
           "bmc3_init", "bmc3_step", "bmg_init", "bmg_step",
           "DGS", "DGSTune", "dgs_step", "dgs_support", "discrete_step",
           "SliceSimplex", "SliceSimplexTune", "slicesimplex_init",
           "slicesimplex_step",
           "AMM", "AMMTune", "amm_adapt", "amm_init", "amm_propose", "amm_step",
           "AMWG", "AMWGTune", "amwg_init", "amwg_step",
           "ChEESHMC", "ChEESTune", "chees_init", "chees_step",
           "HMC", "HMCTune", "hmc_init", "hmc_step",
           "MALA", "MALATune", "mala_init", "mala_step",
           "MISS", "missing_masks",
           "NUTS", "NUTSTune", "nuts_init", "nuts_step", "nutsepsilon",
           "RWM", "RWMTune", "rwm_init", "rwm_step",
           "Slice", "SliceTune", "slice_init", "slice_multivariate_step",
           "slice_univariate_step"]
