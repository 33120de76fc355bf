"""Sampler kernels (reference src/samplers/): each exposes stand-alone
functions ``<name>_init`` / ``<name>_step`` on chain-stacked vectors plus an
engine-facing ``SamplerSpec`` subclass binding the kernel to a block of
model nodes."""

from .base import BlockKernel, SamplerSpec
from .custom import Gibbs
from .nuts import NUTS, NUTSTune, nuts_init, nuts_step, nutsepsilon

__all__ = ["BlockKernel", "SamplerSpec", "Gibbs", "NUTS", "NUTSTune",
           "nuts_init", "nuts_step", "nutsepsilon"]
