"""Engine mechanics of the port, from tests/test_engine.py,
tests/test_extension_api.py and tests/test_parity_gaps.py: determinism
under one seed, restart continuing the chain, thin/burnin bookkeeping (its
iteration ranges equal the JAX package's at the same arguments), monitor
flags, chain indexing and model queries; user distributions and a user
bijector under sampling, and a Wishart node; keys, validators and the
progress meter.

The JAX package's cache test has no counterpart: the port keeps no engine
cache.  The runs are shorter than the JAX tests' (the port's engine is a
host loop, ~25 ms per NUTS iteration on the CPU) and use more chains; each
posterior gate keeps the JAX test's tolerance."""

import io
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu_torch.ops import random as R
from mamba_tpu_torch.ops import bijectors as bij
from mamba_tpu_torch.ops.distributions.base import _randn
from mamba_tpu_torch.ops.distributions import (Distribution,
                                               UnivariateDistribution,
                                               distribution)
from mamba_tpu_torch.samplers import (bhmc_init, bia_init, bmc3_init, bmg_init,
                                      slicesimplex_init, validate,
                                      validatebinary, validatesimplex)
from mamba_tpu_torch.utils.progress import ChainProgress

torch.set_num_threads(2)

X = np.stack([np.ones(5), np.arange(1.0, 6.0)], 1)
Y = np.array([1.0, 3.0, 3.0, 3.0, 5.0])


def line_model(pkg=tmt, samplers=None):
    np_ = jnp if pkg is jmt else torch
    model = pkg.Model(
        y=pkg.Stochastic(1, lambda mu, s2: pkg.Normal(mu, np_.sqrt(s2)),
                         monitor=False),
        mu=pkg.Logical(1, lambda xmat, beta: xmat @ beta, monitor=False),
        beta=pkg.Stochastic(1, lambda: pkg.Normal(np_.zeros(2),
                                                  math.sqrt(1000.0))),
        s2=pkg.Stochastic(lambda: pkg.InverseGamma(0.001, 0.001)),
    )
    model.set_samplers(samplers or [pkg.HMC("beta", 0.1, 10),
                                    pkg.Slice("s2", 3.0)])
    rng = np.random.default_rng(42)
    inits = [{"y": Y, "beta": rng.normal(0, 1, 2), "s2": rng.gamma(1.0)}
             for _ in range(3)]
    return model, {"xmat": X}, inits


def run(model, inputs, inits, iters, **kw):
    kw.setdefault("chains", 2)
    return tmt.mcmc(model, inputs, inits, iters, verbose=False, device="cpu", **kw)


def test_engine_deterministic():
    model, inputs, inits = line_model()
    a = run(model, inputs, inits, 40, burnin=10, seed=7)
    b = run(model, inputs, inits, 40, burnin=10, seed=7)
    np.testing.assert_array_equal(a.value, b.value)
    c = run(model, inputs, inits, 40, burnin=10, seed=8)
    assert not np.array_equal(a.value, c.value)


def test_restart_continues_chain():
    model, inputs, inits = line_model(samplers=[tmt.NUTS("beta"),
                                                tmt.Slice("s2", 3.0)])
    sim = run(model, inputs, inits, 80, burnin=20, thin=2)
    assert sim.iter == 80
    sim2 = tmt.mcmc(sim, 40, verbose=False)
    assert sim2.iter == 120 and sim2.niter == sim.niter + 20
    np.testing.assert_array_equal(sim2.value[:sim.niter], sim.value)
    rng = sim2.range
    assert rng[0] == 22 and rng[-1] == 120 and np.all(np.diff(rng) == 2)
    # restart reuses the adapted NUTS step size (tune continuation,
    # reference sampler.jl:37-47)
    torch.testing.assert_close(sim.states["tunes"][0].epsilon,
                               sim2.states["tunes"][0].epsilon, rtol=0, atol=0)


@pytest.mark.parametrize("iters,burnin,thin", [(100, 20, 4), (50, 7, 4),
                                               (41, 10, 3), (30, 0, 1)])
def test_thin_burnin_bookkeeping_matches_the_reference(iters, burnin, thin):
    def go(pkg):
        model, inputs, inits = line_model(pkg, [pkg.AMWG("beta", np.ones(2)),
                                                pkg.Slice("s2", 3.0)])
        sim = pkg.mcmc(model, inputs, inits, iters, burnin=burnin, thin=thin,
                       chains=1, verbose=False,
                       **({"device": "cpu"} if pkg is tmt else {}))
        more = pkg.mcmc(sim, 2 * thin + 1, verbose=False)
        return sim, more
    (j, j2), (t, t2) = go(jmt), go(tmt)
    assert t.niter == j.niter == (iters - burnin) // thin
    np.testing.assert_array_equal(t.range, j.range)
    assert (t.iter, t.start, t.thin) == (j.iter, j.start, j.thin)
    np.testing.assert_array_equal(t2.range, j2.range)
    assert t2.iter == j2.iter
    assert t.value.shape == (t.niter, 3, 1)   # beta[1], beta[2], s2


def test_monitor_flags_respected():
    model, inputs, inits = line_model()
    sim = run(model, inputs, inits, 20, burnin=5, chains=1)
    assert sim.names == ["beta[1]", "beta[2]", "s2"]  # y, mu unmonitored


def test_chains_indexing():
    model, inputs, inits = line_model()
    sim = run(model, inputs, inits, 60, burnin=20, thin=2, chains=3)
    sub = sim[:, "beta", :]
    assert sub.names == ["beta[1]", "beta[2]"]
    sub2 = sim[:, ["s2"], [0, 2]]
    assert sub2.value.shape == (20, 1, 2)
    win = sim[40:, :, :]
    assert win.range[0] >= 40 and win.thin == 2


def test_model_queries():
    model, _, _ = line_model(samplers=[tmt.NUTS("beta"), tmt.Slice("s2", 3.0)])
    jmodel, _, _ = line_model(jmt, [jmt.NUTS("beta"), jmt.Slice("s2", 3.0)])
    for kind in ("stochastic", "input", "sampled", "observed", "logical",
                 "monitor"):
        assert sorted(model.keys(kind)) == sorted(jmodel.keys(kind)), kind
    assert model.keys("block", 1) == ["beta"]
    assert model.keys("observed") == ["y"]
    dot = model.graph2dot()
    assert '"beta" -> "mu"' in dot and '"xmat" [shape=box' in dot


def test_keys_assigned():
    from mamba_tpu_torch.models import line
    model, inputs, inits = line.build()
    stoch = model.keys("stochastic")
    assert model.keys("assigned") == sorted(model.input_names)
    full = model.keys("assigned", inits[0])
    for n in stoch + model.keys("logical") + sorted(model.input_names):
        assert n in full
    part = model.keys("assigned", {stoch[0]: 1.0})
    assert stoch[0] in part
    assert not any(n in part for n in model.keys("logical"))


# -- the extension API (reference doc/mcmc/newunivardist.jl,
#    newmultivardist.jl, pdmatdistribution.jl) ------------------------------

@distribution
class NewUnivarDist(UnivariateDistribution):
    """The reference's example: f(x|mu,sigma) ~ Normal implemented by hand."""
    mu: torch.Tensor = 0.0
    sigma: torch.Tensor = 1.0

    def log_prob(self, x):
        z = (x - self.mu) / self.sigma
        return -0.5 * z * z - torch.log(self.sigma) - 0.5 * math.log(2 * math.pi)

    def sample(self, key, shape=()):
        mu = torch.as_tensor(self.mu).expand(self.batch_shape)
        return mu + self.sigma * _randn(key, shape, mu)


@distribution
class NewMultivarDist(Distribution):
    """A covariance that is not positive definite (the Slice block on s2
    proposes s2 <= 0) gives NaN, which the engine takes as -inf; torch's
    ``cholesky`` would raise there, so the factor comes from
    ``cholesky_ex``."""
    event_ndim = 1
    mu: torch.Tensor = None
    C: torch.Tensor = None      # covariance

    def log_prob(self, x):
        d = self.mu.shape[-1]
        L, info = torch.linalg.cholesky_ex(self.C)
        L = torch.where((info == 0)[..., None, None], L, torch.nan)
        z = torch.linalg.solve_triangular(L, (x - self.mu)[..., None],
                                          upper=False)[..., 0]
        return (-0.5 * torch.sum(z * z, -1)
                - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
                - 0.5 * d * math.log(2 * math.pi))


def _custom_line(likelihood):
    model = tmt.Model(
        y=tmt.Stochastic(1, likelihood, monitor=False),
        mu=tmt.Logical(1, lambda xmat, beta: xmat @ beta, monitor=False),
        beta=tmt.Stochastic(1, lambda: tmt.Normal(torch.zeros(2),
                                                  math.sqrt(1000.0))),
        s2=tmt.Stochastic(lambda: tmt.InverseGamma(0.001, 0.001)),
    )
    model.set_samplers([tmt.NUTS("beta"), tmt.Slice("s2", 3.0)])
    inits = {"y": Y, "beta": np.zeros(2), "s2": 1.0}
    sim = run(model, {"xmat": X}, [inits], 250, burnin=100, chains=8)
    return tmt.summarystats(sim).to_dict()


def test_line_with_custom_univariate():
    s = _custom_line(lambda mu, s2: NewUnivarDist(mu, torch.sqrt(s2)))
    assert abs(s["beta[2]"]["Mean"] - 0.8017) < 0.12


def test_line_with_custom_multivariate():
    s = _custom_line(lambda mu, s2: NewMultivarDist(mu, s2 * torch.eye(5)))
    assert abs(s["beta[2]"]["Mean"] - 0.8017) < 0.12


def test_custom_dist_with_custom_bijector():
    """A bounded custom distribution picks up link-transformed sampling."""
    @distribution
    class Kumaraswamy(UnivariateDistribution):
        a: torch.Tensor = 2.0
        b: torch.Tensor = 2.0

        def log_prob(self, x):
            a, b = self.a, self.b
            return (math.log(a) + math.log(b) + (a - 1) * torch.log(x)
                    + (b - 1) * torch.log1p(-x ** a))

        def bijector(self):
            return bij.Sigmoid(0.0, 1.0)

        def in_support(self, x):
            return (x > 0) & (x < 1)

    model = tmt.Model(p=tmt.Stochastic(lambda: Kumaraswamy(2.0, 3.0)))
    model.set_samplers([tmt.NUTS("p")])
    sim = run(model, {}, [{"p": 0.5}], 300, burnin=100, chains=16)
    comb = sim.combine()
    assert np.all((comb > 0) & (comb < 1))
    # E[X] = b * Beta(1 + 1/a, b) for Kumaraswamy(a, b)
    from scipy.special import beta as betafn
    exact = 3.0 * betafn(1.5, 3.0)
    assert abs(comb.mean() - exact) < 0.03


def test_wishart_node_sampling():
    """Precision-matrix node through the CholeskyPD bijector under NUTS
    (reference pdmatdistribution.jl path)."""
    rng = np.random.default_rng(0)
    Lam_true = np.array([[2.0, 0.6], [0.6, 1.0]])
    y = rng.multivariate_normal(np.zeros(2), np.linalg.inv(Lam_true), 400)
    model = tmt.Model(
        y=tmt.Stochastic(2, lambda Lam: tmt.MvNormalCanon(torch.zeros(2), Lam),
                         monitor=False),
        Lam=tmt.Stochastic(2, lambda: tmt.Wishart(3.0, torch.eye(2) / 3.0)),
    )
    model.set_samplers([tmt.NUTS("Lam")])
    sim = run(model, {}, [{"y": y, "Lam": np.eye(2)}], 250, burnin=100,
              chains=8)
    s = tmt.summarystats(sim).to_dict()
    assert abs(s["Lam[1,1]"]["Mean"] - Lam_true[0, 0]) < 0.35
    assert abs(s["Lam[1,2]"]["Mean"] - Lam_true[0, 1]) < 0.25
    assert s["Lam[2,2]"]["Mean"] > 0


# -- validators and the progress meter (reference sampler.jl:72-83,
#    progress.jl:5-65) -------------------------------------------------------

def test_validators():
    x = torch.tensor([[0.0, 1.0, 1.0]])
    assert validate(object()) is not None
    assert torch.equal(validatebinary(x), x)
    with pytest.raises(ValueError):
        validatebinary(torch.tensor([[0.0, 2.0]]))
    s = torch.tensor([[0.2, 0.3, 0.5]])
    assert torch.equal(validatesimplex(s), s)
    with pytest.raises(ValueError):
        validatesimplex(torch.tensor([[0.5, 0.9]]))


def test_validators_wired_into_inits():
    bad = torch.tensor([[0.0, 3.0]])
    with pytest.raises(ValueError):
        bhmc_init(R.chain_keys(0, range(1)), bad, 1.0)
    with pytest.raises(ValueError):
        bia_init(bad)
    with pytest.raises(ValueError):
        bmc3_init(bad)
    with pytest.raises(ValueError):
        bmg_init(bad)
    with pytest.raises(ValueError):
        slicesimplex_init(torch.tensor([[0.5, 0.9]]))
    t = slicesimplex_init(torch.tensor([[0.25, 0.75]]), scale=0.5)
    assert float(t.scale) == 0.5


def test_chain_progress_format():
    buf = io.StringIO()
    m = ChainProgress(100, chains=4, stream=buf)
    for _ in range(10):
        m.update(10)
    out = buf.getvalue()
    assert "100 Iterations x 4 Chains" in out
    assert " 10% [" in out and "100% [" in out
    assert "remaining]" in out


def test_progress_defaults_on_with_verbose(capsys):
    model, inputs, inits = line_model()
    tmt.mcmc(model, inputs, inits, 30, burnin=10, chains=2, verbose=True,
             device="cpu")
    out = capsys.readouterr().out
    assert "Iterations x 2 Chains" in out and "remaining]" in out
    tmt.mcmc(model, inputs, inits, 30, burnin=10, chains=2, verbose=False,
             device="cpu")
    assert "remaining]" not in capsys.readouterr().out
