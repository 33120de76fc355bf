"""The port's multivariate and matrix-variate distributions against the JAX
package's, one parametrised case per class (and per form of the ``MvNormal``
factory).

Parameters and points come from ``np.random.default_rng(seed)``; both sides
run in float64 on the CPU.  Compared at rtol 1e-10: ``log_prob`` at batched
parameters, its gradient in ``x`` and in each parameter (for a matrix, the
symmetric part: the two libraries' Cholesky gradients may split a symmetric
matrix's entries differently), ``in_support`` at points in and out of the
support (for Wishart and InverseWishart, matrices just inside and just
outside the cone), the bijector's map, inverse and log-det, the moments and
the shape properties.  Sampling is held in distribution: 50,000 draws from a
seeded generator against the class's own mean, and against the JAX class's
draws coordinate by coordinate."""

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
from mamba_tpu_torch.ops import random as R

torch.set_num_threads(2)

RTOL = 1e-10
N = 5                 # batch elements per case
D = 3                 # event size
NDRAWS = 50_000


def _spd(rng, d, scale=1.0):
    A = rng.normal(0.0, 1.0, (d, d))
    return scale * (A @ A.T / d + np.eye(d))


def _tril(rng, d):
    L = np.tril(rng.normal(0.0, 0.5, (d, d)), -1)
    return L + np.diag(rng.uniform(0.5, 1.5, d))


def _unit(rng, shape):
    v = rng.normal(0.0, 1.0, shape)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _wishart_points(rng, d, n):
    return np.stack([_spd(rng, d, rng.uniform(0.5, 2.0)) for _ in range(n)])


def _edge_of_cone(rng, d, n, sign):
    """Symmetric matrices with their smallest eigenvalue at ``sign * 1e-3``
    of their largest: just inside the cone (+1) or just outside (-1)."""
    out = []
    for _ in range(n):
        Q, _ = np.linalg.qr(rng.normal(0.0, 1.0, (d, d)))
        ev = rng.uniform(1.0, 3.0, d)
        ev[0] = sign * 1e-3 * ev.max()
        out.append((Q * ev) @ Q.T)
    return np.stack(out)


@dataclasses.dataclass
class Case:
    name: str
    params: Callable                  # rng -> {name: numpy value}
    x: Callable                       # (rng, p) -> points inside the support
    out: Callable = None              # (rng, p) -> points outside it
    build: Callable = None            # (module, p) -> distribution
    discrete: bool = False
    matrix: tuple = ()                # matrix parameters (symmetric-part gradients)
    diff: tuple = None                # parameters to differentiate (default: all)
    sample_params: Callable = None    # rng -> unbatched params for the draws
    moments: tuple = ("mean",)
    jax_draws: bool = True            # the JAX class can draw a batch

    def make(self, mod, p):
        if self.build is not None:
            return self.build(mod, p)
        return getattr(mod, self.name)(**p)


def _t(v):
    return torch.as_tensor(v, dtype=torch.float64) if isinstance(
        v, np.ndarray) else v


def _j(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _close(t, j, what, rtol=RTOL, atol=0.0):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _sym(g):
    g = np.asarray(g.detach().numpy() if isinstance(g, torch.Tensor) else g)
    return 0.5 * (g + np.swapaxes(g, -1, -2))


def _seed(name):
    return sum(ord(c) for c in name)


def _mvn(form):
    def build(mod, p):
        return mod.MvNormal(p["mu"], p[form])
    return build


CASES = [
    Case("MvNormalIso", lambda r: dict(mu=r.normal(0, 2, (N, D)),
                                       sigma=r.uniform(0.5, 2, N)),
         # the JAX class's invcov takes an unbatched sigma only
         lambda r, p: r.normal(0, 2, (N, D)), moments=("mean", "cov")),
    Case("MvNormalDiag", lambda r: dict(mu=r.normal(0, 2, (N, D)),
                                        sigma=r.uniform(0.5, 2, (N, D))),
         lambda r, p: r.normal(0, 2, (N, D)), moments=("mean", "cov", "invcov")),
    Case("MvNormalFull", lambda r: dict(mu=r.normal(0, 2, (N, D)),
                                        scale_tril=_tril(r, D)),
         lambda r, p: r.normal(0, 2, (N, D)), matrix=("scale_tril",),
         moments=("mean", "cov", "invcov")),
    Case("MvNormal-isotropic", lambda r: dict(mu=r.normal(0, 2, (N, D)),
                                              s=np.asarray(1.7)),
         lambda r, p: r.normal(0, 2, (N, D)), build=_mvn("s")),
    Case("MvNormal-diagonal", lambda r: dict(mu=r.normal(0, 2, (N, D)),
                                             v=r.uniform(0.5, 2, (N, D))),
         lambda r, p: r.normal(0, 2, (N, D)), build=_mvn("v")),
    Case("MvNormal-full", lambda r: dict(mu=r.normal(0, 2, (N, D)),
                                         S=_spd(r, D)),
         lambda r, p: r.normal(0, 2, (N, D)), build=_mvn("S"), matrix=("S",)),
    # the JAX class solves J h for one h only
    Case("MvNormalCanon", lambda r: dict(h=r.normal(0, 1, D), J=_spd(r, D)),
         lambda r, p: r.normal(0, 2, (N, D)), matrix=("J",),
         moments=("mean", "invcov"), jax_draws=False,
         sample_params=lambda r: dict(h=r.normal(0, 1, D), J=_spd(r, D))),
    Case("MvTDist", lambda r: dict(nu=r.uniform(4, 9, N), mu=r.normal(0, 2, (N, D)),
                                   Sigma=_spd(r, D)),
         lambda r, p: r.normal(0, 2, (N, D)), matrix=("Sigma",)),
    Case("Dirichlet", lambda r: dict(alpha=r.uniform(0.5, 4, (N, D))),
         lambda r, p: r.dirichlet(np.ones(D), N),
         out=lambda r, p: np.concatenate([
             r.dirichlet(np.ones(D), 2) * 1.1,                    # sum 1.1
             np.array([[-0.1, 0.6, 0.5]] * 2),                    # an entry < 0
             np.array([[1.0, 0.0, 0.0]])])),                      # on the edge
    Case("Multinomial", lambda r: dict(n=np.asarray(12.0),
                                       p=r.dirichlet(np.ones(D), N)),
         lambda r, p: r.multinomial(12, [0.2, 0.3, 0.5], N).astype(float),
         out=lambda r, p: np.array([[4.0, 4.0, 5.0]] * 2 + [[13.0, -1.0, 0.0]] * 3),
         discrete=True, diff=("p",)),
    Case("BDiagNormal", lambda r: dict(mu=r.normal(0, 2, 2 * D),
                                       blocks=np.stack([_spd(r, D), _spd(r, D, 2.0)])),
         lambda r, p: r.normal(0, 2, (N, 2 * D)), matrix=("blocks",)),
    # the JAX class's solves want S and x batched alike
    Case("Wishart", lambda r: dict(nu=np.asarray(6.5),
                                   S=_wishart_points(r, D, N)),
         lambda r, p: _wishart_points(r, D, N),
         out=lambda r, p: _edge_of_cone(r, D, N, -1.0), matrix=("S",),
         sample_params=lambda r: dict(nu=np.asarray(7.0), S=_spd(r, D, 0.5))),
    Case("InverseWishart", lambda r: dict(nu=np.asarray(8.0),
                                          Psi=_wishart_points(r, D, N)),
         lambda r, p: _wishart_points(r, D, N),
         out=lambda r, p: _edge_of_cone(r, D, N, -1.0), matrix=("Psi",),
         sample_params=lambda r: dict(nu=np.asarray(10.0), Psi=_spd(r, D))),
    Case("VonMisesFisher", lambda r: dict(mu=_unit(r, (N, D)),
                                          kappa=r.uniform(0.5, 40, N)),
         lambda r, p: _unit(r, (N, D)),
         out=lambda r, p: 1.1 * _unit(r, (N, D))),
]


def _points(case, rng, p):
    return np.asarray(case.x(rng, p), dtype=np.float64)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_density_parity(case):
    rng = np.random.default_rng(_seed(case.name))
    p = case.params(rng)
    x = _points(case, rng, p)
    tp, jp = {k: _t(v) for k, v in p.items()}, {k: _j(v) for k, v in p.items()}
    tdist, jdist = case.make(td, tp), case.make(jd, jp)
    assert type(tdist).__name__ == type(jdist).__name__
    assert tuple(tdist.event_shape) == tuple(jdist.event_shape)
    assert tdist.event_ndim == jdist.event_ndim
    assert tdist.is_discrete == jdist.is_discrete == case.discrete
    if case.name != "BDiagNormal":      # the JAX class drops a leading batch
        assert tuple(tdist.batch_shape) == tuple(jdist.batch_shape)

    lp = tdist.log_prob(_t(x))
    assert lp.dtype == torch.float64 and torch.isfinite(lp).all()
    _close(lp, jdist.log_prob(_j(x)), "log_prob")
    _close(tdist.total_log_prob(_t(x)), jdist.total_log_prob(_j(x)),
           "total_log_prob")

    def tgrad(k, v):
        return torch.func.grad(lambda a: case.make(td, {**tp, k: a}).log_prob(
            _t(x)).sum())(v)

    def jgrad(k, v):
        return jax.grad(lambda a: case.make(jd, {**jp, k: a}).log_prob(
            _j(x)).sum())(v)

    sym_x = tdist.event_ndim == 2
    if not case.discrete:
        g = torch.func.grad(lambda v: case.make(td, tp).log_prob(v).sum())(_t(x))
        jg = jax.grad(lambda v: case.make(jd, jp).log_prob(v).sum())(_j(x))
        _close(_sym(g) if sym_x else g, _sym(jg) if sym_x else jg,
               "d log_prob / dx", atol=1e-12)
    for k in case.diff if case.diff is not None else tuple(p):
        v = np.asarray(p[k], dtype=np.float64)
        g, jg = tgrad(k, _t(v)), jgrad(k, _j(v))
        if k in case.matrix:
            g, jg = _sym(g), _sym(jg)
        _close(g, jg, f"d log_prob / d{k}", atol=1e-12)

    # support: the points inside, then the ones outside
    if case.out is not None:
        bad = np.asarray(case.out(rng, p), dtype=np.float64)
        ts = tdist.in_support(_t(bad))
        assert ts.dtype == torch.bool and not ts.any()
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jdist.in_support(_j(bad))))
    ts = tdist.in_support(_t(x))
    assert ts.all()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jdist.in_support(_j(x))))
    if tdist.event_ndim == 2:            # just inside the cone
        edge = _edge_of_cone(rng, D, N, 1.0)
        assert tdist.in_support(_t(edge)).all()
        assert np.asarray(jdist.in_support(_j(edge))).all()

    # bijector: same type, same map, its inverse and its log-det
    tb, jb = tdist.bijector(), jdist.bijector()
    assert type(tb).__name__ == type(jb).__name__
    ushape = tuple(tb.unconstrained_shape(tuple(x.shape)))
    assert ushape == tuple(jb.unconstrained_shape(tuple(x.shape)))
    u = rng.normal(0.0, 0.7, ushape)
    fwd = tb.forward(_t(u))
    _close(fwd, jb.forward(_j(u)), "bijector.forward")
    if not case.discrete:
        _close(tb.inverse(fwd), u, "bijector round trip", rtol=1e-8, atol=1e-9)
        _close(tb.event_log_det(_t(u), tdist.event_ndim),
               jb.event_log_det(_j(u), jdist.event_ndim), "bijector log det")
        if type(tb).__name__ != "Identity":     # the sphere has no bijector
            assert tdist.in_support(fwd).all()

    for fn in case.moments:
        _close(getattr(tdist, fn)(), getattr(jdist, fn)(), fn)


def _sample_params(case, rng):
    if case.sample_params is not None:
        return case.sample_params(rng)
    p = case.params(rng)
    # one batch element of every batched parameter
    return {k: (v[0] if isinstance(v, np.ndarray) and v.shape[:1] == (N,)
                and k not in case.matrix else v) for k, v in p.items()}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_sampling_in_distribution(case):
    rng = np.random.default_rng(_seed(case.name) + 1)
    p = _sample_params(case, rng)
    tdist = case.make(td, {k: _t(v) for k, v in p.items()})
    jdist = case.make(jd, {k: _j(v) for k, v in p.items()})
    gen = R.key(_seed(case.name))
    before = torch.random.get_rng_state()
    d = tdist.sample(gen, (NDRAWS,))
    assert torch.equal(before, torch.random.get_rng_state()), \
        "a draw came from the global generator"
    assert tuple(d.shape) == (NDRAWS,) + tuple(tdist.batch_shape) + tuple(tdist.event_shape)
    assert torch.isfinite(d).all() and tdist.in_support(d).all()
    again = tdist.sample(R.key(_seed(case.name)), (NDRAWS,))
    assert torch.equal(d, again), "the draws must follow from the generator"
    assert tuple(tdist.sample(gen, (2, 3)).shape[:2]) == (2, 3)

    d = d.reshape(NDRAWS, -1).numpy()
    mean = tdist.mean().reshape(-1).numpy()
    tol = 5.0 * d.std(0) / math.sqrt(NDRAWS) + 1e-12
    assert (np.abs(d.mean(0) - mean) < tol).all(), (d.mean(0), mean)
    if not case.jax_draws:
        # its covariance against the exact one, J^-1, to 5 standard errors
        cov = np.linalg.inv(tdist.invcov().numpy())
        sd = np.sqrt(np.diag(cov))
        se = np.sqrt((cov ** 2 + np.outer(sd ** 2, sd ** 2)) / NDRAWS)
        assert (np.abs(np.cov(d.T) - cov) < 5 * se).all()
        return
    jdraws = np.asarray(jdist.sample(jax.random.key(3), (NDRAWS,)),
                        dtype=np.float64).reshape(NDRAWS, -1)
    for c in range(d.shape[1]):
        if case.discrete:
            se = math.sqrt((d[:, c].var() + jdraws[:, c].var()) / NDRAWS)
            assert abs(d[:, c].mean() - jdraws[:, c].mean()) < 5 * se
            assert abs(d[:, c].std() - jdraws[:, c].std()) < 0.05 * jdraws[:, c].std()
        elif d[:, c].std() > 0:
            # ~60 such tests in the file: 1e-4 each keeps a false alarm rare
            assert stats.ks_2samp(d[:, c], jdraws[:, c]).pvalue > 1e-4, c


def test_sampling_with_chain_stacked_parameters():
    # forward_sample hands every parameter over with a leading chain axis
    rng = np.random.default_rng(7)
    gen = R.key(7)
    C = 4
    S = _t(np.stack([_spd(rng, D) for _ in range(C)]))
    cases = [
        (td.MvNormal(_t(rng.normal(0, 1, (C, D))), S), (C, D)),
        (td.MvNormal(_t(rng.normal(0, 1, (C, D))), _t(rng.uniform(1, 2, C))), (C, D)),
        (td.BDiagNormal(_t(rng.normal(0, 1, (C, 2 * D))),
                        S[:, None].expand(C, 2, D, D)), (C, 2 * D)),
        (td.Multinomial(_t(np.array([5.0, 9.0, 0.0, 3.0])),
                        _t(rng.dirichlet(np.ones(D), C))), (C, D)),
        (td.InverseWishart(3.5, S), (C, D, D)),
        (td.Wishart(_t(np.full(C, 5.0)), S), (C, D, D)),
        (td.Dirichlet(_t(rng.uniform(1, 3, (C, D)))), (C, D)),
        (td.MvTDist(5.0, _t(rng.normal(0, 1, (C, D))), S), (C, D)),
    ]
    for dist, shape in cases:
        assert tuple(dist.batch_shape) == (C,), type(dist).__name__
        v = dist.sample(gen)
        assert tuple(v.shape) == shape and dist.in_support(v).all(), type(dist).__name__
        assert tuple(dist.sample(gen, (6,)).shape) == (6,) + shape
    counts = td.Multinomial(_t(np.array([5.0, 9.0, 0.0, 3.0])),
                            _t(rng.dirichlet(np.ones(D), C))).sample(gen)
    assert counts.sum(-1).tolist() == [5.0, 9.0, 0.0, 3.0]


def test_density_is_nan_free_and_masked_off_the_cone():
    # a covariance that is not positive definite gives NaN factors, which
    # the support mask turns into -inf, as in the JAX package
    bad = _t(_edge_of_cone(np.random.default_rng(3), D, 1, -1.0)[0])
    lp = td.InverseWishart(5.0, torch.eye(D, dtype=torch.float64)).total_log_prob(bad)
    assert lp.item() == -math.inf
    jlp = jd.InverseWishart(5.0, jnp.eye(D)).total_log_prob(jnp.asarray(bad.numpy()))
    assert float(jlp) == -math.inf
    assert torch.isnan(td.MvNormal(torch.zeros(D, dtype=torch.float64), bad)
                       .log_prob(torch.zeros(D, dtype=torch.float64)))


def test_isotropic_precision():
    mu = np.array([0.5, -1.0, 2.0])
    t, j = td.MvNormalIso(_t(mu), _t(np.asarray(1.7))), jd.MvNormalIso(mu, 1.7)
    _close(t.invcov(), j.invcov(), "invcov")
    # batched, where the JAX class has no form: the inverse of cov
    tb = td.MvNormalIso(_t(np.stack([mu, mu])), _t(np.array([0.5, 2.0])))
    _close(tb.invcov(), np.linalg.inv(tb.cov().numpy()), "batched invcov")


@pytest.mark.parametrize("v", [0.0, 0.5, 1.5, 4.0, 9.5])
def test_log_bessel_i_on_both_sides_of_its_switch(v):
    switch = 30.0 + v * v
    z = np.concatenate([np.linspace(0.05, switch - 1e-3, 40),
                        np.linspace(switch + 1e-3, 3 * switch + 50, 40)])
    got = td.log_bessel_i(_t(np.full_like(z, v)), _t(z)).numpy()
    want = np.asarray(jd.log_bessel_i(jnp.full(z.shape, v), jnp.asarray(z)))
    # the JAX package caps the series' argument at 60 + v^2 / 2 and cuts it
    # at 48 terms, which is exact below z = 60 only; the port sums enough
    # terms (ROADMAP, Queue 3)
    exact = (z < 50.0) | (z >= switch)
    np.testing.assert_allclose(got[exact], want[exact], rtol=1e-10)
    # the port against scipy's exponentially scaled I_v: the series to
    # rounding, the three-term asymptotic form to its truncation error
    ref = np.log(scipy.special.ive(v, z)) + z
    series = z < switch
    np.testing.assert_allclose(got[series], ref[series], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[~series], ref[~series],
                               rtol=1e-6 if v < 5 else 1e-4)
    g = torch.func.grad(lambda zz: td.log_bessel_i(v, zz).sum())(_t(z[exact]))
    jg = jax.grad(lambda zz: jd.log_bessel_i(v, zz).sum())(jnp.asarray(z[exact]))
    _close(g, jg, "d log I / dz")
