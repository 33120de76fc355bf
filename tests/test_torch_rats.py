"""The port's rats model against the JAX package's: the joint density and
every sampler block's density and gradient at the same chain states
(rtol 1e-12 in float64: the same terms, summed in the same order up to the
batch reductions), and the conjugate variance block given the same gamma
draws.  Short engine runs of every scheme on the CPU; the golden runs are
marked slow, as their JAX counterparts are."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.models import rats as jrats
from mamba_tpu_torch.models import rats as trats
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

RTOL = 1e-12
C = 4
SCHEMES = ("nuts", "nuts-slice", "reference")


def _states(seed=0):
    """Chain states scattered around the posterior, with y chain-stacked."""
    rng = np.random.default_rng(seed)
    return {
        "y": np.broadcast_to(trats.Y, (C,) + trats.Y.shape).copy(),
        "alpha": rng.normal(240.0, 15.0, (C, 30)),
        "beta": rng.normal(6.2, 0.5, (C, 30)),
        "mu_alpha": rng.normal(240.0, 5.0, C),
        "mu_beta": rng.normal(6.2, 0.2, C),
        "s2_c": rng.uniform(20.0, 60.0, C),
        "s2_alpha": rng.uniform(100.0, 300.0, C),
        "s2_beta": rng.uniform(0.1, 0.5, C),
    }


def _compiled(scheme):
    tm, tin, tinits = trats.build(scheme)
    jm, jin, jinits = jrats.build(scheme)
    return (tmt.compile_model(tm, tin, tinits[0], device="cpu"),
            jmt.compile_model(jm, jin, jinits[0]))


def test_data_and_inits_match():
    tm, tin, tinits = trats.build("nuts")
    jm, jin, jinits = jrats.build("nuts")
    assert set(tin) == set(jin) and set(tm.nodes) == set(jm.nodes)
    for k in tin:
        np.testing.assert_array_equal(np.asarray(tin[k]), np.asarray(jin[k]))
    for t, j in zip(tinits, jinits):
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
    assert trats.GOLDEN == jrats.GOLDEN


def test_logpdf_and_logicals_match():
    tcm, jcm = _compiled("nuts")
    states = _states(1)
    tst = convert.to_tensors(states, "cpu", torch.float64)
    lp = torch.func.vmap(tcm.logpdf)(tst)
    jlp = jax.vmap(jcm.logpdf)({k: jnp.asarray(v) for k, v in states.items()})
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=RTOL)
    a0 = torch.func.vmap(tcm.eval_logicals)(tst)["alpha0"]
    np.testing.assert_allclose(a0.numpy(), states["mu_alpha"]
                               - trats.XBAR * states["mu_beta"], rtol=RTOL)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_block_densities_and_gradients_match(scheme):
    tcm, jcm = _compiled(scheme)
    states = _states(2)
    tst = convert.to_tensors(states, "cpu", torch.float64)
    jst = {k: jnp.asarray(v) for k, v in states.items()}
    blocks = [s for s in tcm.model.samplers if not isinstance(s, tmt.Gibbs)]
    assert blocks
    for spec in blocks:
        pack, _, _, logf = tcm.block_functions(spec.params, spec.transform)
        jpack, _, _, jlogf = jcm.block_functions(spec.params, spec.transform)
        x = torch.func.vmap(pack)(tst)
        jx = jax.vmap(jpack)(jst)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL)
        grads, vals = torch.func.vmap(torch.func.grad_and_value(logf))(x, tst)
        jvals, jgrads = jax.vmap(jax.value_and_grad(jlogf))(jx, jst)
        np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=RTOL,
                                   err_msg=repr(spec))
        np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=RTOL,
                                   atol=1e-12, err_msg=repr(spec))


def test_untransformed_variance_block_is_minus_inf_off_support():
    tcm, _ = _compiled("reference")
    pack, _, _, logf = tcm.block_functions(("mu_beta", "s2_beta"), False)
    tst = convert.to_tensors(_states(3), "cpu", torch.float64)
    x = torch.func.vmap(pack)(tst)
    x[0, 1] = -0.2                          # s2_beta < 0
    lp = torch.func.vmap(logf)(x, tst)
    assert torch.isneginf(lp[0]) and torch.isfinite(lp[1:]).all()


def test_var_gibbs_matches_given_the_same_gamma_draws(monkeypatch):
    states = _states(4)
    rng = np.random.default_rng(5)
    gammas = {k: rng.gamma(a, 1.0, C) for k, a in
              (("s2_c", 75.001), ("s2_alpha", 15.001), ("s2_beta", 15.001))}
    order = ["s2_c", "s2_alpha", "s2_beta"]

    # JAX: its bounded-rounds inverse-gamma sampler, replaced by b / g
    from mamba_tpu.ops import rng as jrng
    calls = []

    def j_ig(key, a, b):
        name = order[len(calls) % 3]
        c = len(calls) // 3
        calls.append((name, float(a)))
        return b / gammas[name][c]

    monkeypatch.setattr(jrng, "inverse_gamma_bounded", j_ig)
    jm, jin, _ = jrats.build("nuts")
    j_gibbs = jm.samplers[1]
    jout = []
    for c in range(C):
        env = {k: jnp.asarray(v[c]) for k, v in states.items()}
        env.update({k: jnp.asarray(v) for k, v in jin.items()})
        jout.append({k: float(v) for k, v in
                     j_gibbs.fn(jax.random.key(c), env).items()})
    assert [a for _, a in calls[:3]] == [75.001, 15.001, 15.001]

    # the port: one chain-batched draw per variance, in the same order
    shapes = []

    def t_ig(gen, a, scale):
        shapes.append(a)
        return scale / torch.as_tensor(gammas[order[len(shapes) - 1]])

    monkeypatch.setattr(trats, "_inverse_gamma", t_ig)
    env = convert.to_tensors(states, "cpu", torch.float64)
    env.update(convert.to_tensors(trats.build("nuts")[1], "cpu", torch.float64))
    out = trats.var_gibbs(None, env)
    assert shapes == [75.001, 15.001, 15.001]
    for k in order:
        np.testing.assert_allclose(out[k].numpy(), [j[k] for j in jout], rtol=RTOL)


def test_inverse_gamma_draws_follow_their_law():
    # the port's gamma draw on the shapes the model uses: KS against scipy
    from scipy import stats
    gen = torch.Generator().manual_seed(3)
    scale = torch.full((20000,), 40.0, dtype=torch.float64)
    d = trats._inverse_gamma(gen, 75.001, scale).numpy()
    assert stats.kstest(d, stats.invgamma(75.001, scale=40.0).cdf).pvalue > 1e-3


@pytest.mark.parametrize("scheme", SCHEMES)
def test_schemes_run_in_the_engine(scheme):
    model, inputs, inits = trats.build(scheme)
    sim = tmt.mcmc(model, inputs, inits, 24, burnin=12, chains=2,
                   verbose=False, device="cpu")
    assert sim.names == ["alpha0", "mu_beta", "s2_c"]
    assert np.isfinite(sim.value).all()
    state = sim.states["state"]
    for k in ("s2_c", "s2_alpha", "s2_beta"):
        assert (state[k] > 0).all(), k


@pytest.mark.slow
def test_rats_nuts_scheme_golden():
    # the JAX package's test_rats_nuts_scheme_agrees, on the port
    model, inputs, inits = trats.build("nuts")
    sim = tmt.mcmc(model, inputs, inits, 1700, burnin=700, chains=16,
                   verbose=False, device="cpu")
    s = tmt.summarystats(sim).to_dict()
    assert abs(s["mu_beta"]["Mean"] - 6.1831) < 0.05
    assert abs(s["s2_c"]["Mean"] - 37.254) < 3.0
    assert float(np.max(tmt.rhat_rank(sim.value))) < 1.01
    assert float(np.min(tmt.ess_bulk(sim.value))) > 400


@pytest.mark.slow
def test_rats_chees_from_advi_golden():
    # the JAX package's test_chees_hierarchical_rats_gated, on the port
    model, inputs, inits = trats.build("nuts")
    model.set_samplers([tmt.ChEESHMC(model.samplers[0].params, mass_window=50),
                        *model.samplers[1:]])
    res = tmt.advi(model, inputs, inits[0], steps=1500, nmc=4, seed=1,
                   device="cpu")
    chains = 64
    draws = {k: v.numpy() for k, v in
             res.sample(torch.Generator().manual_seed(5), chains).items()}
    warm = [dict(inits[0], **{k: d[i] for k, d in draws.items()})
            for i in range(chains)]
    sim = tmt.mcmc(model, inputs, warm, 1000, burnin=300, chains=chains,
                   verbose=False, device="cpu", seed=5)
    s = tmt.summarystats(sim).to_dict()
    assert abs(s["mu_beta"]["Mean"] - 6.1831) < 0.05
    assert abs(s["s2_c"]["Mean"] - 37.254) < 3.0
    assert float(np.max(tmt.rhat_rank(sim.value))) < 1.01
    assert float(np.min(tmt.ess_bulk(sim.value))) > 400
