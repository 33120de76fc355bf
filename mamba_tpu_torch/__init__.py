"""mamba_tpu_torch: the PyTorch/CUDA port of mamba_tpu.

A DAG-based hierarchical-model DSL, block-wise Gibbs sampling with pluggable
sampler kernels over a batch of chains, and Mamba's posterior summaries — in
PyTorch, for one NVIDIA GPU (Hopper), with the JAX package ``mamba_tpu`` as
its reference.  Hot functions the JAX package wrote as TPU kernels are
hand-written CUDA kernels here (``csrc/``), each beside a plain torch
version that CPU tensors take.
"""

from .ops import bijectors
from .ops import distributions as dists
from .ops.distributions import *  # noqa: F401,F403
from .model.nodes import Logical, Stochastic
from .model.model import Model
from .model.compile import CompiledModel, compile_model
from .model.mcmc import mcmc
from . import samplers
from .samplers import (ABC, AMM, AMWG, BHMC, BIA, BMC3, BMG, DGS, HMC, MALA,
                       MISS, NUTS, RWM, ChEESHMC, Gibbs, Slice, SliceSimplex,
                       chees_init, chees_step)
from . import infer
from .infer import ADVIResult, SMCResult, advi, smc
from . import models
from .utils.math import cummean, invlogit, logit
from . import maxpost
from .maxpost import MAPResult, optim_over
from . import output
from . import parallel
from .output import (Chains, ModelChains, ChainSummary, autocor, changerate,
                     cor, describe, dic, ess_bulk, ess_rhat, ess_tail,
                     gelmandiag, gewekediag, heideldiag,
                     hpd, logpdf_chains, mcse, predict, quantile, rafterydiag,
                     rhat_rank, plot, draw, read_chains, readcoda,
                     summarystats, write_chains)

__version__ = "0.1.0"
