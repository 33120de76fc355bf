"""Distribution library (batched torch): the univariate, discrete, mixed,
multivariate and matrix-variate families."""

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
from .multivariate import (MvNormal, MvNormalIso, MvNormalDiag, MvNormalFull,
                           MvNormalCanon, MvTDist, Dirichlet, Multinomial,
                           BDiagNormal, Wishart, InverseWishart)
from .multivariate_extra import VonMisesFisher, log_bessel_i

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
    "MvNormal", "MvNormalIso", "MvNormalDiag", "MvNormalFull", "MvNormalCanon",
    "Mixed", "Blockwise",
    "MvTDist", "Dirichlet", "Multinomial", "BDiagNormal", "Wishart",
    "InverseWishart", "VonMisesFisher", "log_bessel_i",
]
