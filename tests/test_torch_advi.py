"""The port's ADVI against the JAX package's.

Parity: 20 Adam steps on the line model with the same Monte Carlo noise on
both sides (JAX's noise is its own scan's draws, replayed into the port):
``mu``, ``log_sigma`` and the ELBO trace agree at rtol 1e-8 in float64 (the
two optimizers round their bias corrections in another order, and the
reparameterization gradient is written out in the port).  Then the JAX
package's ADVI tests (tests/test_infer.py) on the port."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu_torch.models import line as tline
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

# the packages' ``infer`` re-exports the function under the module's name
jadvi = importlib.import_module("mamba_tpu.infer.advi")
tadvi = importlib.import_module("mamba_tpu_torch.infer.advi")

RTOL = 1e-8


def _jax_noise(seed, steps, nmc, d):
    """The noise JAX's ADVI scan draws: split the key each step, one
    (nmc, d) normal from the subkey."""
    key, out = jax.random.key(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (nmc, d), jnp.float64)))
    return out


def test_advi_matches_given_the_same_noise(monkeypatch):
    steps, nmc, seed = 20, 4, 3
    jmodel, jinputs, jinits = jmt.models.line.build()
    jres = jadvi.advi(jmodel, jinputs, jinits[0], steps=steps, nmc=nmc,
                      lr=0.05, seed=seed)
    noise = _jax_noise(seed, steps, nmc, 3)
    monkeypatch.setattr(tadvi, "_mc_noise", lambda gen, n, d, like: torch.tensor(
        noise.pop(0), dtype=like.dtype, device=like.device))
    model, inputs, inits = tline.build()
    res = tmt.advi(model, inputs, inits[0], steps=steps, nmc=nmc, lr=0.05,
                   seed=seed, device="cpu")
    assert not noise
    assert res.params == tuple(jres.params)
    np.testing.assert_allclose(res.elbo_trace, np.asarray(jres.elbo_trace), rtol=RTOL)
    np.testing.assert_allclose(res.mu.numpy(), np.asarray(jres.mu), rtol=RTOL)
    np.testing.assert_allclose(res.log_sigma.numpy(), np.asarray(jres.log_sigma),
                               rtol=RTOL)
    for k, v in res.mean_state().items():
        np.testing.assert_allclose(v, jres.mean_state()[k], rtol=RTOL)


def test_jax_fit_carried_into_the_port_samples_the_same(monkeypatch):
    jmodel, jinputs, jinits = jmt.models.line.build()
    jres = jadvi.advi(jmodel, jinputs, jinits[0], steps=300, nmc=4, lr=0.05)
    model, inputs, inits = tline.build()
    res = convert.advi_result(np.asarray(jres.mu), np.asarray(jres.log_sigma),
                              model, inputs, inits[0], device="cpu")
    for k, v in res.mean_state().items():
        np.testing.assert_allclose(v, jres.mean_state()[k], rtol=1e-12)
    for k, v in res.unconstrained_variances().items():
        np.testing.assert_allclose(v, jres.unconstrained_variances()[k], rtol=1e-12)
    key = jax.random.key(9)
    jdraws = jres.sample(key, 50)
    z = np.asarray(jax.random.normal(key, (50, 3), jnp.float64))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.tensor(z))
    draws = res.sample(torch.Generator(), 50)
    assert set(draws) == set(jdraws) == {"beta", "s2"}
    for k in draws:
        np.testing.assert_allclose(draws[k].numpy(), np.asarray(jdraws[k]), rtol=1e-12)


def conjugate_model():
    y = np.array([1.1, 0.7, 1.4, 0.9, 1.2, 1.0, 0.8, 1.3])
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu: tmt.Normal(mu.expand(8), 1.0), monitor=False),
        mu=tmt.Stochastic(lambda: tmt.Normal(0.0, np.sqrt(2.0))))
    model.set_samplers([tmt.NUTS("mu")])
    v = 1 / (8 + 0.5)
    return model, y, v * y.sum(), np.sqrt(v)


def test_advi_conjugate():
    # the last Adam iterate is noisy: its sd misses the exact one by up to
    # ~0.04 over seeds in both packages (seeds 0-5, CPU)
    model, y, m_exact, sd_exact = conjugate_model()
    a = tmt.advi(model, {}, {"y": y, "mu": 0.0}, steps=3000, lr=0.05, seed=1,
                 device="cpu")
    assert a.params == ("mu",)
    assert abs(float(a.mu[0]) - m_exact) < 0.05
    assert abs(float(torch.exp(a.log_sigma[0])) - sd_exact) < 0.06
    assert a.elbo_trace[-50:].mean() > a.elbo_trace[:50].mean()
    draws = a.sample(torch.Generator().manual_seed(0), 4000)
    assert draws["mu"].shape == (4000,)
    assert abs(draws["mu"].numpy().mean() - m_exact) < 0.05


def test_advi_mass_warm_started_nuts():
    # ADVI's variances seed NUTS's diagonal inverse mass; with
    # mass_window=0 the seed survives the run unrefreshed
    model, inputs, inits = tline.build()
    a = tmt.advi(model, inputs, inits[0], steps=2000, lr=0.05, device="cpu")
    ms = a.mean_state()
    assert abs(ms["beta"][1] - 0.8) < 0.25 and ms["s2"] > 0
    var = a.unconstrained_variances()
    assert set(var) == {"beta", "s2"}
    assert var["beta"].shape == (2,) and np.all(var["beta"] > 0)
    minv0 = np.ravel(var["beta"])
    model.set_samplers([tmt.NUTS("beta", minv0=minv0), tmt.Slice("s2", 2.0)])
    sim = tmt.mcmc(model, inputs, a.as_inits(inits[0]), 300, burnin=100,
                   chains=2, verbose=False, device="cpu")
    assert np.isfinite(sim.value).all()
    tune = sim.states["tunes"][0]
    np.testing.assert_allclose(tune.minv[0].numpy(), minv0, rtol=1e-12)
