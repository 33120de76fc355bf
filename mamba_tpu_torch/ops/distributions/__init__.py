"""Distribution library (batched torch): the univariate, discrete and mixed
families; the multivariate ones are still to be ported."""

from .base import (Distribution, UnivariateDistribution,
                   DiscreteUnivariateDistribution, distribution)
from .univariate import (Normal, LogNormal, Exponential, Gamma, InverseGamma,
                         Beta, Uniform, Cauchy, Laplace, Logistic, TDist,
                         Chisq, Weibull, Pareto, Gumbel, Flat, SymUniform,
                         Truncated)
from .univariate_extra import (Arcsine, BetaPrime, Biweight, Chi, Cosine,
                               Epanechnikov, Erlang, FDist, Frechet,
                               InverseGaussian, Kolmogorov, KSDist,
                               KSOneSided, Levy, NoncentralBeta,
                               NoncentralChisq, NoncentralF, NoncentralT,
                               NormalCanon, Rayleigh, SymTriangularDist,
                               TriangularDist, Triweight, VonMises)
from .discrete import (Bernoulli, Binomial, Poisson, Geometric,
                       NegativeBinomial, Categorical, DiscreteUniform,
                       Hypergeometric)
from .discrete_extra import PoissonBinomial, Skellam, NoncentralHypergeometric
from .mixed import Blockwise, Mixed

__all__ = [
    "Distribution", "UnivariateDistribution", "DiscreteUnivariateDistribution",
    "distribution",
    "Normal", "LogNormal", "Exponential", "Gamma", "InverseGamma", "Beta",
    "Uniform", "Cauchy", "Laplace", "Logistic", "TDist", "Chisq", "Weibull",
    "Pareto", "Gumbel", "Flat", "SymUniform", "Truncated",
    "Arcsine", "BetaPrime", "Biweight", "Chi", "Cosine", "Epanechnikov",
    "Erlang", "FDist", "Frechet", "InverseGaussian", "Kolmogorov", "KSDist",
    "KSOneSided", "Levy", "NoncentralBeta", "NoncentralChisq", "NoncentralF",
    "NoncentralT", "NormalCanon", "Rayleigh", "SymTriangularDist",
    "TriangularDist", "Triweight", "VonMises",
    "Bernoulli", "Binomial", "Poisson", "Geometric", "NegativeBinomial",
    "Categorical", "DiscreteUniform", "Hypergeometric",
    "PoissonBinomial", "Skellam", "NoncentralHypergeometric",
    "Mixed", "Blockwise",
]
