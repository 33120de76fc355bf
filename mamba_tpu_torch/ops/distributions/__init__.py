"""Distribution library (batched torch)."""

from .base import (Distribution, UnivariateDistribution,
                   DiscreteUnivariateDistribution, distribution)
from .univariate import Normal, InverseGamma
from .discrete import Bernoulli

__all__ = [
    "Distribution", "UnivariateDistribution", "DiscreteUnivariateDistribution",
    "distribution", "Normal", "InverseGamma", "Bernoulli",
]
