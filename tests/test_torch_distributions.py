"""The port's univariate, discrete and mixed distributions against the JAX
package's, one parametrised case per class.

Parameters and points come from ``np.random.default_rng(seed)``; both sides
run in float64 on the CPU (the JAX side under x64, as ``conftest.py`` sets
it).  Compared: ``log_prob``, its gradient in ``x`` and in each real-valued
parameter (``torch.func.grad`` against ``jax.grad``), ``cdf``/``sf``/
``icdf``/``isf`` where the JAX class has them, ``in_support`` at points in
and out of the support, the bijector's type with a forward/inverse round
trip, ``mean``/``variance``, ``support_bounds`` and the shape properties.

Tolerance: rtol 1e-10 (``RTOL``); rtol 1e-8 (``RTOL_SERIES``) where the
port's own ``betainc``, a bisection or the two libraries' incomplete gamma
functions are on the path.  The two packages draw different random streams,
so sampling is held in distribution: 50,000 draws from a seeded generator
against the class's own ``cdf`` (a KS statistic) or its own ``mean``, and
against the JAX class's draws where it has neither."""

import dataclasses
import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
from scipy import stats

import mamba_tpu.ops.distributions as jd
import mamba_tpu_torch.ops.distributions as td
from mamba_tpu_torch.utils.math import betainc

torch.set_num_threads(2)

RTOL = 1e-10
RTOL_SERIES = 1e-8
N = 6                 # batch elements per case
NDRAWS = 50_000


def U(lo, hi):
    return lambda rng: rng.uniform(lo, hi, N)


def const(v):
    return lambda rng: v


@dataclasses.dataclass
class Case:
    """One class (or factory) of both packages, how to build it from a dict
    of numpy parameters, and where to evaluate it."""
    name: str
    params: dict                      # name -> fn(rng) -> numpy value / number
    x: Callable                       # fn(rng, p) -> points inside the support
    out: Callable = None              # fn(rng, p) -> points outside it
    diff: tuple = None                # parameters to differentiate (default: float arrays)
    rtol: float = RTOL
    build: Callable = None            # fn(module, p) -> distribution
    discrete: bool = False
    grad_x: bool = True
    moment_rtol: float = None         # mean / variance (default: rtol)
    atol: float = 0.0                 # log_prob and its gradients

    def make(self, mod, p):
        if self.build is not None:
            return self.build(mod, p)
        return getattr(mod, self.name)(**p)


def _t(v):
    return torch.as_tensor(v, dtype=torch.float64) if isinstance(
        v, np.ndarray) else v


def _j(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _tp(p):
    return {k: _t(v) for k, v in p.items()}


def _jp(p):
    return {k: _j(v) for k, v in p.items()}


def _close(t, j, rtol, what, atol=0.0):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _seed(name):
    return sum(ord(c) for c in name)


def check_density(case: Case):
    rng = np.random.default_rng(_seed(case.name))
    p = {k: f(rng) for k, f in case.params.items()}
    x = np.asarray(case.x(rng, p), dtype=np.float64)
    tdist, jdist = case.make(td, _tp(p)), case.make(jd, _jp(p))
    tx, jx = _t(x), _j(x)
    rtol = case.rtol

    # shapes and kind
    assert tuple(tdist.batch_shape) == tuple(jdist.batch_shape)
    assert tuple(tdist.event_shape) == tuple(jdist.event_shape)
    assert tdist.event_ndim == jdist.event_ndim
    assert tdist.is_discrete == jdist.is_discrete == case.discrete

    # density and its gradients
    lp = tdist.log_prob(tx)
    assert lp.dtype == torch.float64
    assert np.isfinite(lp.numpy()).all(), "points must lie inside the support"
    _close(lp, jdist.log_prob(jx), rtol, "log_prob", atol=case.atol)
    _close(tdist.total_log_prob(tx), jdist.total_log_prob(jx), rtol,
           "total_log_prob", atol=N * case.atol)
    if case.grad_x and not case.discrete:
        g = torch.func.grad(lambda v: case.make(td, _tp(p)).log_prob(v).sum())(tx)
        jg = jax.grad(lambda v: case.make(jd, _jp(p)).log_prob(v).sum())(jx)
        _close(g, jg, rtol, "d log_prob / dx", atol=max(case.atol, 1e-12))
    diff = case.diff if case.diff is not None else tuple(
        k for k, v in p.items()
        if isinstance(v, np.ndarray) and v.dtype == np.float64)
    for k in diff:
        g = torch.func.grad(lambda v: case.make(
            td, {**_tp(p), k: v}).log_prob(tx).sum())(_t(np.asarray(p[k], float)))
        jg = jax.grad(lambda v: case.make(
            jd, {**_jp(p), k: v}).log_prob(jx).sum())(_j(np.asarray(p[k], float)))
        _close(g, jg, rtol, f"d log_prob / d{k}", atol=max(case.atol, 1e-12))

    # distribution functions, where the JAX class has them
    for fn in ("cdf", "sf"):
        assert hasattr(tdist, fn) == hasattr(jdist, fn), fn
        if hasattr(jdist, fn):
            # atol: a tail value of 1e-7 that is a difference of O(1) terms
            # agrees to the last bit of those terms, not to rtol of itself
            _close(getattr(tdist, fn)(tx), getattr(jdist, fn)(jx), rtol, fn,
                   atol=1e-15)
    q = rng.uniform(0.02, 0.98, x.shape)
    for fn in ("icdf", "isf"):
        assert hasattr(tdist, fn) == hasattr(jdist, fn), fn
        if hasattr(jdist, fn):
            _close(getattr(tdist, fn)(_t(q)), getattr(jdist, fn)(_j(q)), rtol, fn)

    # support
    pts = x if case.out is None else np.concatenate(
        [x, np.asarray(case.out(rng, p), dtype=np.float64)])
    if case.out is not None:
        p2 = {k: (np.concatenate([v, v]) if isinstance(v, np.ndarray)
                  and v.shape[:1] == (N,) else v) for k, v in p.items()}
    else:
        p2 = p
    ts = case.make(td, _tp(p2)).in_support(_t(pts))
    js = case.make(jd, _jp(p2)).in_support(_j(pts))
    assert ts.dtype == torch.bool
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.numpy()[: len(x)].all()
    if case.out is not None:
        assert not ts.numpy()[len(x):].any()

    # bijector: same type, same map, and a round trip
    tb, jb = tdist.bijector(), jdist.bijector()
    assert type(tb).__name__ == type(jb).__name__
    u = rng.normal(0.0, 1.0, x.shape)
    fwd = tb.forward(_t(u))
    _close(fwd, jb.forward(_j(u)), rtol, "bijector.forward")
    if not case.discrete:
        _close(tb.inverse(fwd), u, 1e-8, "bijector round trip", atol=1e-9)
        _close(tb.forward_log_det(_t(u)), jb.forward_log_det(_j(u)), rtol,
               "bijector.forward_log_det", atol=1e-12)
        assert case.make(td, _tp(p)).in_support(fwd).all()

    # moments and support bounds
    for fn in ("mean", "variance"):
        try:
            want = getattr(jdist, fn)()
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                getattr(tdist, fn)()
            continue
        _close(getattr(tdist, fn)(), want, case.moment_rtol or rtol, fn)
    if case.discrete:
        for t, j, what in zip(tdist.support_bounds(), jdist.support_bounds(),
                              ("lower bound", "upper bound")):
            _close(t, j, rtol, what)


def _scalar_params(case, rng):
    p = {k: f(rng) for k, f in case.params.items()}
    return {k: (v[0] if isinstance(v, np.ndarray) and v.shape[:1] == (N,)
                else v) for k, v in p.items()}


def check_sampling(case: Case):
    rng = np.random.default_rng(_seed(case.name) + 1)
    p = _scalar_params(case, rng)
    p = {k: (np.asarray(v) if isinstance(v, np.generic) else v)
         for k, v in p.items()}
    tdist, jdist = case.make(td, _tp(p)), case.make(jd, _jp(p))
    gen = torch.Generator().manual_seed(_seed(case.name))
    before = torch.random.get_rng_state()
    d = tdist.sample(gen, (NDRAWS,))
    assert torch.equal(before, torch.random.get_rng_state()), \
        "a draw came from the global generator"
    assert d.shape[0] == NDRAWS and torch.isfinite(d).all()
    assert tuple(d.shape[1:]) == tuple(tdist.batch_shape) + tuple(tdist.event_shape)
    again = tdist.sample(torch.Generator().manual_seed(_seed(case.name)), (NDRAWS,))
    assert torch.equal(d, again), "the draws must follow from the generator"
    assert tdist.in_support(d).all()
    d = d.reshape(NDRAWS, -1).numpy().astype(np.float64)
    # prepended shape and batch shape compose
    assert tuple(tdist.sample(gen, (2, 3)).shape[:2]) == (2, 3)

    checked = False
    if hasattr(tdist, "cdf") and not case.discrete and d.shape[1] == 1:
        cdf = lambda v: tdist.cdf(torch.as_tensor(v)).numpy()   # noqa: E731
        assert stats.kstest(d[:, 0], cdf).pvalue > 1e-3
        checked = True
    try:
        mean = np.asarray(tdist.mean().numpy(), dtype=np.float64).reshape(-1)
        if np.isfinite(mean).all() and np.isfinite(d.std(0)).all() \
                and case.name not in ("TDist", "Cauchy", "Levy", "Flat"):
            tol = 5.0 * d.std(0) / math.sqrt(NDRAWS) + 1e-12
            assert (np.abs(d.mean(0) - mean) < tol).all(), (d.mean(0), mean)
            checked = True
        var = np.asarray(tdist.variance().numpy(), dtype=np.float64).reshape(-1)
        assert (np.abs(d.var(0) / var - 1.0) < 0.1).all(), (d.var(0), var)
    except NotImplementedError:
        pass
    if not checked or case.discrete:
        jdraws = np.asarray(jdist.sample(jax.random.key(3), (NDRAWS,)),
                            dtype=np.float64).reshape(NDRAWS, -1)
        for c in range(d.shape[1]):
            if case.discrete:     # means and spreads of the two samples
                se = math.sqrt((d[:, c].var() + jdraws[:, c].var()) / NDRAWS)
                assert abs(d[:, c].mean() - jdraws[:, c].mean()) < 5 * se + 1e-9
                assert abs(d[:, c].std() - jdraws[:, c].std()) < \
                    0.05 * jdraws[:, c].std() + 1e-9
            else:
                assert stats.ks_2samp(d[:, c], jdraws[:, c]).pvalue > 1e-3


def _pos(lo=0.05, hi=4.0):
    return lambda rng, p: rng.uniform(lo, hi, N)


def _real(scale=2.0):
    return lambda rng, p: rng.normal(0.0, scale, N)


def _unit(rng, p):
    return rng.uniform(0.02, 0.98, N)


def _between(a, b):
    return lambda rng, p: p[a] + (p[b] - p[a]) * rng.uniform(0.05, 0.95, N)


def _trunc(base, base_params):
    def build(mod, p):
        b = getattr(mod, base)(**{k: p[k] for k in base_params})
        return mod.Truncated(b, p["lo"], p["hi"])
    return build


def _counts(hi):
    return lambda rng, p: rng.integers(0, hi, N).astype(float)


CASES = [
    Case("Normal", dict(mu=U(-2, 2), sigma=U(0.5, 2)), _real()),
    Case("LogNormal", dict(mu=U(-1, 1), sigma=U(0.3, 1.5)), _pos(),
         out=lambda rng, p: -rng.uniform(0, 2, N)),
    Case("Exponential", dict(theta=U(0.3, 3)), _pos(),
         out=lambda rng, p: -rng.uniform(0.1, 2, N)),
    Case("Gamma", dict(alpha=U(0.5, 5), theta=U(0.3, 3)), _pos(),
         out=lambda rng, p: -rng.uniform(0, 2, N), rtol=RTOL_SERIES),
    Case("InverseGamma", dict(alpha=U(1.5, 5), beta=U(0.3, 3)), _pos(),
         out=lambda rng, p: -rng.uniform(0, 2, N), rtol=RTOL_SERIES),
    Case("Beta", dict(alpha=U(0.5, 5), beta=U(0.5, 5)), _unit,
         out=lambda rng, p: 1.0 + rng.uniform(0, 2, N), rtol=RTOL_SERIES),
    Case("Uniform", dict(a=U(-2, 0), b=U(0.5, 3)), _between("a", "b"),
         out=lambda rng, p: p["b"] + rng.uniform(0.1, 1, N)),
    Case("Cauchy", dict(mu=U(-2, 2), sigma=U(0.5, 2)), _real()),
    Case("Laplace", dict(mu=U(-2, 2), beta=U(0.5, 2)), _real()),
    Case("Logistic", dict(mu=U(-2, 2), theta=U(0.5, 2)), _real()),
    Case("TDist", dict(nu=U(1.5, 8)), _real()),
    Case("Chisq", dict(nu=U(1, 8)), _pos(),
         out=lambda rng, p: -rng.uniform(0, 2, N), rtol=RTOL_SERIES),
    Case("Weibull", dict(alpha=U(0.7, 3), theta=U(0.5, 3)), _pos(),
         out=lambda rng, p: -rng.uniform(0, 2, N)),
    Case("Pareto", dict(alpha=U(1, 4), theta=U(0.5, 2)),
         lambda rng, p: p["theta"] * (1.0 + rng.uniform(0.05, 3, N)),
         out=lambda rng, p: p["theta"] * rng.uniform(0.1, 0.9, N)),
    Case("Gumbel", dict(mu=U(-2, 2), beta=U(0.5, 2)), _real()),
    Case("Flat", dict(), _real()),
    Case("SymUniform", dict(mu=U(-2, 2), scale=U(0.5, 2)),
         lambda rng, p: p["mu"] + p["scale"] * rng.uniform(-0.9, 0.9, N),
         out=lambda rng, p: p["mu"] + p["scale"] * 1.5),
    # Truncated: both bounds (cdf/icdf path), a lower bound on a base without
    # icdf (the bisection), survival-space (Weibull), an improper base, and
    # the port's own betainc (Beta)
    Case("Truncated", dict(mu=U(-1, 1), sigma=U(0.5, 2), lo=U(-2, -1),
                           hi=U(1, 2)), _between("lo", "hi"),
         out=lambda rng, p: p["hi"] + rng.uniform(0.1, 1, N),
         build=_trunc("Normal", ("mu", "sigma"))),
]
TRUNCATED = [
    Case("Truncated-Gamma-lower", dict(alpha=U(1, 4), theta=U(0.5, 2),
                                       lo=U(0.2, 1), hi=const(math.inf)),
         lambda rng, p: p["lo"] + rng.uniform(0.05, 3, N),
         out=lambda rng, p: p["lo"] * rng.uniform(0.1, 0.9, N),
         diff=("theta", "lo"), rtol=RTOL_SERIES,
         build=_trunc("Gamma", ("alpha", "theta"))),
    Case("Truncated-Weibull-survival", dict(alpha=U(0.8, 3), theta=U(0.5, 3),
                                            lo=U(0.2, 4), hi=const(math.inf)),
         lambda rng, p: p["lo"] + rng.uniform(0.05, 3, N),
         out=lambda rng, p: p["lo"] * rng.uniform(0.1, 0.9, N),
         build=_trunc("Weibull", ("alpha", "theta"))),
    Case("Truncated-Flat-upper", dict(lo=const(-math.inf), hi=U(-1, 1)),
         lambda rng, p: p["hi"] - rng.uniform(0.05, 3, N),
         out=lambda rng, p: p["hi"] + rng.uniform(0.05, 3, N),
         build=lambda mod, p: mod.Truncated(mod.Flat(), p["lo"], p["hi"])),
    Case("Truncated-Beta", dict(alpha=U(0.8, 4), beta=U(0.8, 4),
                                lo=U(0.05, 0.3), hi=U(0.6, 0.95)),
         _between("lo", "hi"), out=lambda rng, p: p["hi"] + 0.01,
         # jax.scipy's betainc has no derivative in a and b; the port's has
         diff=("lo", "hi"), rtol=RTOL_SERIES,
         build=_trunc("Beta", ("alpha", "beta"))),
    Case("Truncated-unbounded", dict(mu=U(-1, 1), sigma=U(0.5, 2),
                                     lo=const(-math.inf), hi=const(math.inf)),
         _real(), build=_trunc("Normal", ("mu", "sigma"))),
]
DISCRETE = [
    Case("Bernoulli", dict(p=U(0.1, 0.9)),
         lambda rng, p: rng.integers(0, 2, N).astype(float),
         out=lambda rng, p: np.full(N, 2.0), discrete=True),
    Case("Binomial", dict(n=lambda rng: rng.integers(5, 30, N).astype(float),
                          p=U(0.1, 0.9)),
         lambda rng, p: np.floor(p["n"] * rng.uniform(0, 1, N)),
         out=lambda rng, p: p["n"] + 1.0, diff=("p",), discrete=True),
    Case("Poisson", dict(lam=U(0.5, 12)), _counts(20),
         out=lambda rng, p: np.full(N, 2.5), discrete=True),
    Case("Geometric", dict(p=U(0.1, 0.9)), _counts(12),
         out=lambda rng, p: np.full(N, -1.0), discrete=True),
    Case("NegativeBinomial", dict(r=U(0.5, 6), p=U(0.2, 0.8)), _counts(15),
         out=lambda rng, p: np.full(N, 0.5), discrete=True),
    Case("Categorical", dict(p=lambda rng: rng.dirichlet(np.ones(5), N)),
         lambda rng, p: rng.integers(1, 6, N).astype(float),
         out=lambda rng, p: np.full(N, 6.0), discrete=True),
    Case("DiscreteUniform",
         dict(a=lambda rng: rng.integers(-3, 1, N).astype(float),
              b=lambda rng: rng.integers(2, 9, N).astype(float)),
         lambda rng, p: np.floor(p["a"] + (p["b"] - p["a"] + 1)
                                 * rng.uniform(0, 0.999, N)),
         out=lambda rng, p: p["b"] + 1.0, diff=(), discrete=True),
    Case("Hypergeometric",
         dict(ns=lambda rng: rng.integers(5, 12, N).astype(float),
              nf=lambda rng: rng.integers(3, 10, N).astype(float),
              n=lambda rng: rng.integers(4, 8, N).astype(float)),
         lambda rng, p: np.floor(np.maximum(0, p["n"] - p["nf"]) + (
             np.minimum(p["ns"], p["n"]) - np.maximum(0, p["n"] - p["nf"]) + 1)
             * rng.uniform(0, 0.999, N)),
         out=lambda rng, p: np.minimum(p["ns"], p["n"]) + 1.0, diff=(),
         discrete=True),
]


@pytest.mark.parametrize("case", CASES + TRUNCATED + DISCRETE,
                         ids=lambda c: c.name)
def test_density_parity(case):
    check_density(case)


@pytest.mark.parametrize("case", CASES + TRUNCATED + DISCRETE,
                         ids=lambda c: c.name)
def test_sampling_in_distribution(case):
    check_sampling(case)


# ---------------------------------------------------------------------------
# Mixed / Blockwise
# ---------------------------------------------------------------------------

def _mixed(mod, s=0.7):
    return mod.Mixed(mod.InverseGamma(2.0, 1.5), mod.Uniform(0.0, 50.0),
                     mod.Normal(s, 2.0),
                     mod.Truncated(mod.Normal(0.0, 1.3), 0.0, math.inf),
                     mod.Beta(2.0, 3.0))


def test_mixed_parity():
    rng = np.random.default_rng(11)
    x = np.stack([rng.uniform(0.2, 3, 4), rng.uniform(1, 40, 4),
                  rng.normal(0, 1, 4), rng.uniform(0.1, 2, 4),
                  rng.uniform(0.1, 0.9, 4)], axis=-1)
    tm, jm = _mixed(td), _mixed(jd)
    assert tuple(tm.batch_shape) == tuple(jm.batch_shape) == ()
    assert tuple(tm.event_shape) == tuple(jm.event_shape) == (5,)
    assert tm.event_ndim == jm.event_ndim == 1
    _close(tm.log_prob(_t(x)), jm.log_prob(_j(x)), RTOL, "log_prob")
    g = torch.func.grad(lambda v: tm.log_prob(v).sum())(_t(x))
    _close(g, jax.grad(lambda v: jm.log_prob(v).sum())(_j(x)), RTOL, "grad x")
    g = torch.func.grad(lambda s: _mixed(td, s).log_prob(_t(x)).sum())(
        torch.tensor(0.7, dtype=torch.float64))
    _close(g, jax.grad(lambda s: _mixed(jd, s).log_prob(_j(x)).sum())(0.7),
           RTOL, "grad parameter")
    bad = x.copy()
    bad[1, 4] = 1.5
    bad[2, 0] = -1.0
    np.testing.assert_array_equal(tm.in_support(_t(bad)).numpy(),
                                  np.asarray(jm.in_support(_j(bad))))
    assert tm.in_support(_t(bad)).tolist() == [True, False, False, True]
    with pytest.raises(ValueError, match="univariate"):
        td.Mixed(td.Normal(), td.Mixed(td.Normal()))
    assert td.Mixed([td.Normal(), td.Flat()]).event_shape == (2,)


def test_blockwise_parity():
    rng = np.random.default_rng(12)
    tb, jb = _mixed(td).bijector(), _mixed(jd).bijector()
    assert isinstance(tb, td.Blockwise) and isinstance(jb, jd.Blockwise)
    assert [type(b).__name__ for b in tb.parts] == \
        [type(b).__name__ for b in jb.parts] == \
        ["Exp", "Sigmoid", "Identity", "LowerBounded", "Sigmoid"]
    u = rng.normal(0, 1, (4, 5))
    x = tb.forward(_t(u))
    _close(x, jb.forward(_j(u)), RTOL, "forward")
    _close(tb.inverse(x), u, 1e-9, "round trip", atol=1e-10)
    _close(tb.inverse(x), jb.inverse(jnp.asarray(x.numpy())), 1e-9, "inverse",
           atol=1e-10)
    _close(tb.forward_log_det(_t(u)), jb.forward_log_det(_j(u)), RTOL, "log det")
    _close(tb.event_log_det(_t(u), 1), jb.event_log_det(_j(u), 1), RTOL,
           "event log det")
    assert _mixed(td).in_support(x).all()


def test_mixed_sampling_in_distribution():
    gen = torch.Generator().manual_seed(5)
    before = torch.random.get_rng_state()
    d = _mixed(td).sample(gen, (NDRAWS,))
    assert torch.equal(before, torch.random.get_rng_state())
    assert d.shape == (NDRAWS, 5) and _mixed(td).in_support(d).all()
    d = d.numpy().astype(np.float64)
    assert stats.kstest(d[:, 0], stats.invgamma(2.0, scale=1.5).cdf).pvalue > 1e-3
    assert stats.kstest(d[:, 1], stats.uniform(0, 50).cdf).pvalue > 1e-3
    assert stats.kstest(d[:, 2], stats.norm(0.7, 2.0).cdf).pvalue > 1e-3
    assert stats.kstest(d[:, 3], stats.halfnorm(scale=1.3).cdf).pvalue > 1e-3
    assert stats.kstest(d[:, 4], stats.beta(2.0, 3.0).cdf).pvalue > 1e-3
    # chain-stacked elements keep their batch; constant ones are drawn iid
    s = torch.linspace(-1, 1, 7, dtype=torch.float64)
    d = _mixed(td, s).sample(gen)
    assert d.shape == (7, 5) and len(torch.unique(d[:, 1])) == 7
    d = _mixed(td, s).sample(gen, (3,))
    assert d.shape == (3, 7, 5)


# ---------------------------------------------------------------------------
# the protocol, the exports and the port's own special functions
# ---------------------------------------------------------------------------

def test_exports_are_the_jax_package_s_minus_the_multivariate_names():
    # the multivariate names were the last ones missing: the port now
    # exports the JAX package's whole list
    assert set(td.__all__) == set(jd.__all__)
    assert len(td.__all__) == len(set(td.__all__))
    for name in td.__all__:
        assert hasattr(td, name)
    import mamba_tpu_torch as tmt
    for name in td.__all__:
        assert getattr(tmt, name) is getattr(td, name)


def test_every_exported_class_has_a_parity_case():
    from test_torch_distributions_extra import EXTRA, DISCRETE_EXTRA
    from test_torch_distributions_mv import CASES as MV
    covered = {c.name.split("-")[0] for c in
               CASES + TRUNCATED + DISCRETE + EXTRA + DISCRETE_EXTRA + MV}
    covered |= {"Mixed", "Blockwise", "Distribution", "UnivariateDistribution",
                "DiscreteUnivariateDistribution", "distribution",
                "log_bessel_i"}
    assert covered == set(td.__all__)


def test_protocol_base_classes():
    # the base classes' defaults, against the JAX package's
    @td.distribution
    class TBox(td.UnivariateDistribution):
        w: torch.Tensor = 1.0

        def log_prob(self, x):
            return -torch.log(torch.as_tensor(self.w)) + 0.0 * x

        def in_support(self, x):
            return (x >= 0) & (x <= self.w)

    @jd.distribution()
    class JBox(jd.UnivariateDistribution):
        w: jax.Array = 1.0

        def log_prob(self, x):
            return -jnp.log(self.w) + 0.0 * x

        def in_support(self, x):
            return (x >= 0) & (x <= self.w)

    w = np.array([1.0, 2.0, 4.0])
    x = np.array([0.5, 2.5, 3.0])
    tb, jb = TBox(_t(w)), JBox(_j(w))
    assert dataclasses.is_dataclass(tb)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tb.w = 2.0
    assert tuple(tb.batch_shape) == tuple(jb.batch_shape) == (3,)
    assert tuple(tb.param_shapes[0]) == tuple(jb.param_shapes[0])
    assert type(tb.bijector()).__name__ == type(jb.bijector()).__name__
    assert float(tb.total_log_prob(_t(x))) == float(jb.total_log_prob(_j(x))) \
        == -math.inf
    inside = np.array([0.5, 1.5, 3.0])
    _close(tb.total_log_prob(_t(inside)), jb.total_log_prob(_j(inside)), RTOL,
           "total_log_prob")
    for t, j in ((td.Distribution(), jd.Distribution()),
                 (td.UnivariateDistribution(), jd.UnivariateDistribution()),
                 (td.DiscreteUnivariateDistribution(),
                  jd.DiscreteUnivariateDistribution())):
        assert t.event_ndim == j.event_ndim and t.is_discrete == j.is_discrete
        assert type(t.bijector()).__name__ == type(j.bijector()).__name__
        for fn in ("mean", "variance"):
            with pytest.raises(NotImplementedError):
                getattr(t, fn)()
        with pytest.raises(NotImplementedError):
            t.log_prob(_t(x))
    with pytest.raises(NotImplementedError):
        td.DiscreteUnivariateDistribution().support_bounds()


@pytest.mark.parametrize("lo,hi", [(0.05, 5.0), (1.0, 100.0), (100.0, 8000.0)])
def test_betainc_against_scipy(lo, hi):
    # the port's own regularized incomplete beta: relative 1e-10 over a grid
    # of parameters; for large parameters x is taken near the mean, where
    # the function is neither 0 nor 1
    rng = np.random.default_rng(int(hi))
    a, b = rng.uniform(lo, hi, 4000), rng.uniform(lo, hi, 4000)
    x = rng.uniform(0.0, 1.0, 4000)
    if lo >= 100:
        x = np.clip(a / (a + b) + rng.normal(0, 0.01, 4000), 1e-6, 1 - 1e-6)
    want = scipy.special.betainc(a, b, x)
    got = betainc(_t(a), _t(b), _t(x)).numpy()
    ok = want > 1e-280
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-10)
    np.testing.assert_allclose(got, want, atol=1e-13, rtol=1e-10)


def test_betainc_edges_and_gradient():
    x = torch.tensor([0.0, 1.0], dtype=torch.float64)
    assert betainc(2.0, 3.0, x).tolist() == [0.0, 1.0]
    # d/dx I_x(a, b) is the Beta density
    a, b = 2.5, 1.7
    x = torch.tensor([0.1, 0.4, 0.8], dtype=torch.float64)
    g = torch.func.grad(lambda v: betainc(a, b, v).sum())(x)
    np.testing.assert_allclose(g.numpy(), stats.beta(a, b).pdf(x.numpy()),
                               rtol=1e-8)
    assert betainc(torch.tensor(2.0), torch.tensor(3.0),
                   torch.tensor(0.3)).dtype == torch.float32


def test_truncated_bijector_is_chosen_without_reading_a_batched_bound():
    T, Nrm = td.Truncated, td.Normal()
    assert type(T(Nrm, 0.0, 1.0).bijector()).__name__ == "Sigmoid"
    assert type(T(Nrm, 0.0, math.inf).bijector()).__name__ == "LowerBounded"
    assert type(T(Nrm, -math.inf, 1.0).bijector()).__name__ == "UpperBounded"
    assert type(T(Nrm).bijector()).__name__ == "Identity"
    assert type(T(td.Gamma(), -math.inf, math.inf).bijector()).__name__ == "Exp"
    lo = torch.tensor([0.0, 1.0], dtype=torch.float64)      # a model input
    x = torch.tensor([[0.5, 1.5], [0.7, 2.0]], dtype=torch.float64)

    def logp(row):
        d = T(Nrm, lo, math.inf)
        b = d.bijector()
        return (d.log_prob(row) + b.forward_log_det(b.inverse(row))).sum()

    out = torch.func.vmap(torch.func.grad(logp))(x)
    assert torch.isfinite(out).all() and lo._all_finite is True
    with pytest.raises(ValueError, match="per-chain"):
        torch.func.vmap(lambda v: T(Nrm, v, math.inf).bijector().forward(v))(lo)
