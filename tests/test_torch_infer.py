"""MAP and SMC in the port against the JAX package (tests/test_infer.py):
the optimum of each MAP method on line and on a small GLMM (the fused
build, which takes the kernel's plain version on the CPU, and the generic
one), a MAP warm start, and SMC on the conjugate normal model and on line,
whose particles agree in distribution; the systematic resampling index
clamp.

Adam runs the same iterates in both packages.  L-BFGS and BFGS are other
implementations in the port, so parity is on the optimum: the JAX
package's L-BFGS optimum (its BFGS stops far from the optimum on line:
``jax.scipy``'s line search, which the JAX package's docstring calls
unreliable on heavy-tailed posteriors)."""

import numpy as np
import pytest
import torch
from scipy import stats

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.models import glmm as jglmm, line as jline
from mamba_tpu_torch.infer.smc import systematic_resample
from mamba_tpu_torch.ops import random as R
from mamba_tpu_torch.models import glmm as tglmm, line as tline

torch.set_num_threads(2)


def conjugate_model():
    y = np.array([1.1, 0.7, 1.4, 0.9, 1.2, 1.0, 0.8, 1.3])
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu: tmt.Normal(mu.expand(8), 1.0),
                         monitor=False),
        mu=tmt.Stochastic(lambda: tmt.Normal(0.0, np.sqrt(2.0))))
    model.set_samplers([tmt.NUTS("mu")])
    v = 1 / (8 + 0.5)
    return model, y, v * y.sum(), np.sqrt(v)


def _optimum(params, ref, atol):
    for k, v in ref.items():
        np.testing.assert_allclose(params[k], v, rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def line_map():
    model, inputs, inits = jline.build()
    return jmt.optim_over(model, inputs, inits[0])


@pytest.mark.parametrize("method", ["lbfgs", "bfgs"])
def test_map_line_reaches_the_reference_optimum(method, line_map):
    model, inputs, inits = tline.build()
    r = tmt.optim_over(model, inputs, inits[0], method=method, device="cpu")
    assert r.converged and r.niter < 500
    _optimum(r.params, line_map.params, 2e-5)
    np.testing.assert_allclose(r.params["beta"], [0.6, 0.8], atol=0.02)
    assert r.logpdf >= line_map.logpdf - 1e-8


def test_map_line_adam_follows_the_reference_iterates():
    model, inputs, inits = jline.build()
    j = jmt.optim_over(model, inputs, inits[0], method="adam", maxiter=300,
                       lr=0.05)
    model, inputs, inits = tline.build()
    t = tmt.optim_over(model, inputs, inits[0], method="adam", maxiter=300,
                       lr=0.05, device="cpu")
    _optimum(t.params, j.params, 1e-9)
    np.testing.assert_allclose(t.logpdf, j.logpdf, rtol=1e-10)
    assert t.niter == j.niter == 300


@pytest.mark.parametrize("fused", [True, False])
def test_map_glmm_matches_the_reference(fused):
    jm, ji, jinits, _ = jglmm.build(G=32, n=10, seed=1, fused=False)
    j = jmt.optim_over(jm, ji, jinits[0])
    tm, ti, tinits, _ = tglmm.build(G=32, n=10, seed=1, fused=fused)
    t = tmt.optim_over(tm, ti, tinits[0], device="cpu")
    assert t.converged
    _optimum(t.params, {k: j.params[k] for k in ("beta", "z")}, 1e-4)
    np.testing.assert_allclose(t.params["s2"], j.params["s2"], rtol=1e-4)
    np.testing.assert_allclose(t.logpdf, j.logpdf, rtol=1e-7)


def test_map_glmm_at_full_width_matches_the_reference():
    """The map phase's gates of chip_smoke.py, set from this run: at
    G = 10,000 both packages' float64 MAP beta lies 0.1304 from the truth
    (gate 0.15), and the port's fused float32 MAP lies within 1e-3 of the
    float64 one."""
    jm, ji, jinits, truth = jglmm.build(G=10_000, fused=False)
    j = jmt.optim_over(jm, ji, jinits[0])
    tm, ti, tinits, _ = tglmm.build(G=10_000, fused=False)
    t = tmt.optim_over(tm, ti, tinits[0], device="cpu")
    assert t.converged
    np.testing.assert_allclose(t.params["beta"], j.params["beta"], rtol=0,
                               atol=1e-6)
    for beta in (t.params["beta"], j.params["beta"]):
        assert 0.12 < np.abs(beta - truth["beta"]).max() < 0.15
    tm, ti, tinits, _ = tglmm.build(G=10_000, fused=True)
    t32 = tmt.optim_over(tm, ti, tinits[0], device="cpu", dtype=torch.float32)
    assert np.abs(t32.params["beta"] - j.params["beta"]).max() < 1e-3


def test_map_needs_a_device_and_a_known_method():
    model, inputs, inits = tline.build()
    with pytest.raises(ValueError, match="explicit device"):
        tmt.optim_over(model, inputs, inits[0])
    with pytest.raises(ValueError, match="unknown method"):
        tmt.optim_over(model, inputs, inits[0], method="newton", device="cpu")


def test_map_as_warm_start():
    model, inputs, inits = tline.build()
    r = tmt.optim_over(model, inputs, inits[0], device="cpu")
    y = np.array([1., 3., 3., 3., 5.])
    start = r.as_inits({"y": y})
    assert set(start) == {"y", "beta", "s2"}
    sim = tmt.mcmc(model, inputs, [start], 60, burnin=20, chains=2,
                   verbose=False, device="cpu")
    assert np.all(np.isfinite(sim.value))


# -- SMC ---------------------------------------------------------------------

def _conjugate_gates(N, seed, tol_mean, tol_sd):
    model, y, m_exact, sd_exact = conjugate_model()
    r = tmt.smc(model, {}, {"y": y, "mu": 0.0}, n_particles=N, seed=seed,
                device="cpu")
    mu = r.particles["mu"]
    assert mu.shape == (N,)
    assert abs(mu.mean() - m_exact) < tol_mean
    assert abs(mu.std() - sd_exact) < tol_sd
    S = np.eye(8) + 2.0 * np.ones((8, 8))
    logZ_exact = stats.multivariate_normal(np.zeros(8), S).logpdf(y)
    assert abs(r.log_evidence - logZ_exact) < 0.3
    assert r.n_stages <= 5 and r.ess_final == 1.0


def test_smc_conjugate_1024():
    # a quarter of the reference's particles: twice its mean and sd gates
    _conjugate_gates(1024, 2, 0.06, 0.08)


@pytest.mark.slow
def test_smc_conjugate_exact():
    _conjugate_gates(4096, 2, 0.03, 0.04)


def _line_gates(N, seed):
    model, inputs, inits = tline.build()
    r = tmt.smc(model, inputs, inits[0], n_particles=N,
                rejuvenation_steps=50, seed=seed, device="cpu")
    b = r.particles["beta"].mean(0)
    assert abs(b[0] - 0.60) < 0.35
    assert abs(b[1] - 0.80) < 0.12
    assert 1.0 <= r.n_stages <= 30
    assert np.all(r.particles["s2"] > 0)
    return r


def test_smc_line_posterior_1024():
    _line_gates(1024, 3)


@pytest.mark.slow
def test_smc_line_posterior():
    _line_gates(4096, 3)


def test_smc_line_agrees_with_the_reference_in_distribution():
    model, inputs, inits = jline.build()
    j = jmt.smc(model, inputs, inits[0], n_particles=1024,
                rejuvenation_steps=50, seed=3)
    t = _line_gates(1024, 4)
    for p in ("beta", "s2"):
        a, b = np.atleast_2d(t.particles[p].T), np.atleast_2d(j.particles[p].T)
        for row_t, row_j in zip(a, b):
            assert stats.ks_2samp(row_t, row_j).pvalue > 1e-4, p
    assert abs(t.n_stages - j.n_stages) <= 3


def test_smc_glmm_recovers_beta_in_both_packages():
    """The smc phase's GLMM gate of chip_smoke.py (the recovery gate, 0.35)
    is met by both packages at G = 64 and 1024 particles, and by the port
    in float32 with the phase's 20 RWM steps per stage."""
    jm, ji, jinits, truth = jglmm.build(G=64, n=10, seed=2, fused=False,
                                        mass_window=50)
    j = jmt.smc(jm, ji, jinits[0], n_particles=1024, seed=0)
    tm, ti, tinits, _ = tglmm.build(G=64, n=10, seed=2, fused=True,
                                    mass_window=50)
    t = tmt.smc(tm, ti, tinits[0], n_particles=1024, seed=0, device="cpu")
    t32 = tmt.smc(tm, ti, tinits[0], n_particles=1024, seed=0,
                  rejuvenation_steps=20, device="cpu", dtype=torch.float32)
    for r in (j, t, t32):
        assert np.abs(r.particles["beta"].mean(0) - truth["beta"]).max() < 0.35
        assert np.isfinite(r.log_evidence) and r.n_stages < 100


def test_smc_needs_a_device_and_no_mesh():
    """A device is required; a mesh must be a torch DeviceMesh (particles
    sharded over one: tests/test_torch_multiproc.py)."""
    model, y, _, _ = conjugate_model()
    with pytest.raises(ValueError, match="explicit device"):
        tmt.smc(model, {}, {"y": y, "mu": 0.0})
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmt.smc(model, {}, {"y": y, "mu": 0.0}, mesh=object(), device="cpu")


def test_systematic_resample_clamps_to_the_last_particle(monkeypatch):
    """float32 weights whose cumulative sum ends below 1, and the uniform
    just under 1: the last stratified point lies above the sum, where
    searchsorted returns n.  The index is clamped to n - 1 (the JAX
    package's gather clamps it silently)."""
    n = 1000
    logw = 3.0 * torch.randn(n, generator=torch.Generator().manual_seed(0))
    cum = torch.cumsum(torch.softmax(logw, 0), 0)
    assert float(cum[-1]) < 1.0
    u0 = torch.tensor(1.0 - 2 ** -24)        # the largest float32 below 1
    pts = (u0 + torch.arange(n, dtype=torch.float32)) / n
    assert int(torch.searchsorted(cum, pts)[-1]) == n
    monkeypatch.setattr(R, "uniform", lambda *a, **k: u0)
    idx = systematic_resample(R.key(0), logw, n)
    assert int(idx[-1]) == n - 1 and int(idx.max()) == n - 1


def test_systematic_resample_draws_by_weight():
    w = torch.tensor([0.5, 0.25, 0.125, 0.125], dtype=torch.float64)
    idx = systematic_resample(R.key(1), torch.log(w), 4096)
    counts = torch.bincount(idx, minlength=4).double() / 4096
    torch.testing.assert_close(counts, w, rtol=0, atol=1 / 4096)
