"""The port's first slice end to end on the CPU: the GLMM sampled by NUTS
through ``mcmc`` recovers its fixed effects, restarts continue the run, the
fused model's NUTS-block gradient agrees with the JAX package's at the same
chain states, and the centered build's Gibbs block runs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu_torch.models import glmm
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)


def test_fused_glmm_short_mcmc_recovers_and_restarts():
    model, inputs, inits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                             mass_window=50)
    sim = tmt.mcmc(model, inputs, inits, 400, burnin=150, chains=4,
                   verbose=False, device="cpu")
    assert sim.value.shape == (250, 5, 4) and np.isfinite(sim.value).all()
    s = tmt.summarystats(sim).to_dict()
    est = np.array([s[f"beta[{i + 1}]"]["Mean"] for i in range(4)])
    assert np.abs(est - truth["beta"]).max() < 0.35
    assert set(sim.timing) == {"setup_s", "sample_s", "fetch_s"}

    more = tmt.mcmc(sim, 20, verbose=False)
    assert list(more.range[[0, -1]]) == [151, 420]
    assert more.value.shape == (270, 5, 4)
    np.testing.assert_array_equal(more.value[:250], sim.value)
    assert not np.array_equal(more.value[250], sim.value[-1])


def test_restart_continues_the_random_stream():
    # one run of 30 kept draws == 20 kept draws then a restart of 10
    model, inputs, inits, _ = glmm.build(G=16, n=5, seed=4, fused=True,
                                         mass_window=0)
    kw = dict(burnin=5, chains=2, verbose=False, device="cpu", seed=9)
    whole = tmt.mcmc(model, inputs, inits, 35, **kw)
    part = tmt.mcmc(tmt.mcmc(model, inputs, inits, 25, **kw), 10, verbose=False)
    np.testing.assert_allclose(part.value, whole.value, rtol=1e-12)


def test_fused_block_gradient_matches_jax_at_the_same_states():
    G, C = 32, 3
    tm, tin, tinit, _ = glmm.build(G=G, n=6, seed=5, fused=True)
    jm, jin, jinit, _ = jmt.models.glmm.build(G=G, n=6, seed=5, fused=True)
    rng = np.random.default_rng(8)
    states = {"beta": rng.normal(0, 1, (C, 4)), "z": rng.normal(0, 1, (C, G)),
              "s2": np.exp(rng.normal(0, 0.3, C)),
              "y": np.broadcast_to(tinit[0]["y"], (C, 6, G)).copy()}

    tcm = tmt.compile_model(tm, tin, tinit[0], device="cpu")
    kernel = tcm.model.samplers[0]
    pack, _, _, logf = tcm.block_functions(kernel.params, kernel.transform)
    tst = convert.to_tensors(states, "cpu", torch.float64)
    x = torch.func.vmap(pack)(tst)
    grads, vals = torch.func.vmap(torch.func.grad_and_value(logf))(x, tst)

    jcm = jmt.compile_model(jm, jin, jinit[0])
    jpack, _, _, jlogf = jcm.block_functions(kernel.params, True)
    jst = {k: jnp.asarray(v) for k, v in states.items()}
    jx = jax.vmap(jpack)(jst)
    jvals, jgrads = jax.vmap(jax.value_and_grad(jlogf))(jx, jst)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-10)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-10)


def test_centered_build_runs_nuts_and_gibbs():
    model, inputs, inits, _ = glmm.build(G=16, n=5, seed=3, fused=True,
                                         centered=True, mass_window=0)
    sim = tmt.mcmc(model, inputs, inits, 30, burnin=10, chains=3,
                   verbose=False, device="cpu")
    s2 = sim.value[:, sim.names.index("s2"), :]
    assert np.isfinite(sim.value).all() and (s2 > 0).all()
    assert len(np.unique(s2)) > 10           # the Gibbs block draws anew
