"""The port's univariate model zoo against the JAX package's, model by model:
data, inits and GOLDEN are equal; the joint density, the monitored logical
nodes and every sampler block's density and gradient agree at the same
seeded chain states, rtol 1e-10 in float64 (the same terms; sums may be
taken in another order).  One short engine run per model on the CPU; the
golden runs are marked slow, as their JAX counterparts are, and hold the
gates of the JAX package's golden tests."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu_torch.model.mcmc import _chain_inits
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

RTOL = 1e-10
C = 4
REQUIRED = ("pumps", "dyes", "surgical", "seeds", "blocker", "oxford", "salm",
            "epil", "stacks", "leuk", "mice", "dogs", "magnesium", "bones")
MODELS = REQUIRED + ("equiv", "lsat", "inhalers", "kidney")
#: every scheme a model's ``build`` offers
SCHEMES = [(m, None) for m in MODELS] + [
    (m, "nuts") for m in ("seeds", "oxford", "epil", "leuk", "equiv", "lsat")]


def _mods(name):
    return (importlib.import_module(f"mamba_tpu_torch.models.{name}"),
            importlib.import_module(f"mamba_tpu.models.{name}"))


def _build(mod, scheme):
    return mod.build() if scheme is None else mod.build(scheme)


#: kidney's censored likelihood underflows a step away from its inits
NOISE = {"kidney": 0.01}


def _states(name, tcm, inits, seed):
    """Chain states near the first init: observed sites as the engine stacks
    them (NaN entries prior-imputed), sampled sites moved by N(0, 0.1) in
    their unconstrained space, so every state is inside its support.
    inhalers' cutpoints, whose supports are each other's values on a
    (-1000, 1000) scale, move by N(0, 0.05) as they are."""
    rng = np.random.default_rng(seed)
    scale = NOISE.get(name, 0.1)
    state = _chain_inits(tcm, inits[0], C)
    sampled = {p for s in tcm.model.samplers if not isinstance(s, tmt.MISS)
               for p in s.params}
    out = {}
    for site, v in state.items():
        if name == "inhalers" and site in ("a1", "a2", "a3"):
            v = v + torch.as_tensor(rng.normal(0.0, 0.05, v.shape))
        elif site in sampled:
            b = tcm.example_dists[site].bijector()
            u = b.inverse(v)
            v = b.forward(u + torch.as_tensor(rng.normal(0.0, scale, u.shape)))
        out[site] = v.numpy().copy()
    return out


@pytest.mark.parametrize("name", MODELS)
def test_data_inits_and_golden_match(name):
    tmod, jmod = _mods(name)
    tm, tin, tinits = tmod.build()
    jm, jin, jinits = jmod.build()
    assert set(tin) == set(jin) and set(tm.nodes) == set(jm.nodes)
    assert [type(s).__name__ for s in tm.samplers] == \
        [type(s).__name__ for s in jm.samplers]
    assert [s.params for s in tm.samplers] == [s.params for s in jm.samplers]
    for k in tin:
        np.testing.assert_array_equal(np.asarray(tin[k]), np.asarray(jin[k]))
    assert len(tinits) == len(jinits)
    for t, j in zip(tinits, jinits):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
    if hasattr(jmod, "GOLDEN"):
        assert tmod.GOLDEN == jmod.GOLDEN


@pytest.mark.parametrize("name,scheme", SCHEMES)
def test_densities_and_gradients_match(name, scheme):
    tmod, jmod = _mods(name)
    tm, tin, tinits = _build(tmod, scheme)
    jm, jin, jinits = _build(jmod, scheme)
    tcm = tmt.compile_model(tm, tin, tinits[0], device="cpu")
    jcm = jmt.compile_model(jm, jin, jinits[0])
    assert {n: s.shape for n, s in tcm.sites.items()} == \
        {n: tuple(s.shape) for n, s in jcm.sites.items()}
    assert {n: s.unconstrained_shape for n, s in tcm.sites.items()} == \
        {n: tuple(s.unconstrained_shape) for n, s in jcm.sites.items()}

    states = _states(name, tcm, tinits, seed=len(name))
    tst = convert.to_tensors(states, "cpu", torch.float64)
    jst = {k: jnp.asarray(v) for k, v in states.items()}
    lp = torch.func.vmap(tcm.logpdf)(tst)
    jlp = jax.vmap(jcm.logpdf)(jst)
    assert np.isfinite(np.asarray(jlp)).all()
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=RTOL)

    _, labels, pack_mon = tcm.monitor_spec()
    _, jlabels, jpack_mon = jcm.monitor_spec()
    assert labels == jlabels
    np.testing.assert_allclose(torch.func.vmap(pack_mon)(tst).numpy(),
                               np.asarray(jax.vmap(jpack_mon)(jst)),
                               rtol=RTOL, atol=1e-14)

    blocks = [s for s in tcm.model.samplers if not isinstance(s, tmt.MISS)]
    assert blocks
    for spec in blocks:
        pack, unpack, _, logf = tcm.block_functions(spec.params, spec.transform)
        jpack, _, _, jlogf = jcm.block_functions(spec.params, spec.transform)
        x = torch.func.vmap(pack)(tst)
        jx = jax.vmap(jpack)(jst)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL,
                                   atol=1e-14, err_msg=repr(spec))
        back = torch.func.vmap(unpack)(x, tst)
        for p in spec.params:
            np.testing.assert_allclose(back[p].numpy(), states[p], rtol=RTOL,
                                       atol=1e-12, err_msg=p)
        grads, vals = torch.func.vmap(torch.func.grad_and_value(logf))(x, tst)
        jvals, jgrads = jax.vmap(jax.value_and_grad(jlogf))(jx, jst)
        np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=RTOL,
                                   err_msg=repr(spec))
        np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads),
                                   rtol=RTOL, atol=1e-9, err_msg=repr(spec))


@pytest.mark.parametrize("name,scheme", SCHEMES)
def test_runs_in_the_engine(name, scheme):
    tmod, _ = _mods(name)
    model, inputs, inits = _build(tmod, scheme)
    if name == "kidney":
        # its second init imputes censored times that overflow, which is why
        # the JAX package's own kidney test starts every chain from the first
        inits = [inits[0]]
    sim = tmt.mcmc(model, inputs, inits, 12, burnin=6, chains=2,
                   verbose=False, device="cpu")
    assert sim.value.shape[0] == 6 and sim.value.shape[2] == 2
    assert np.isfinite(sim.value).all()
    for v in sim.states["state"].values():
        assert torch.isfinite(v).all()


def test_zoo_is_exported():
    for name in MODELS:
        assert name in tmt.models.__all__ and hasattr(tmt.models, name)


# ---- golden runs: the gates of the JAX package's golden tests -------------
# (model, scheme, iters, burnin, thin, {label: (mean, tolerance)})
GOLDEN_RUNS = [
    ("pumps", None, 6000, 2000, 2, {"alpha": (0.6968, 0.08),
                                    "beta": (0.9304, 0.16),
                                    "theta[1]": (0.0599, 0.01)}),
    ("dyes", None, 6000, 2000, 2, {"theta": (1526.72, 8.0),
                                   "mu[1]": (1511.48, 8.0)}),
    ("surgical", None, 6000, 2000, 2, {"mu": (-2.550, 0.12),
                                       "pop_mean": (0.0731, 0.01),
                                       "p[1]": (0.0536, 0.012)}),
    ("seeds", None, 8000, 2500, 2, {"alpha0": (-0.5562, 0.15),
                                    "alpha12": (-0.7464, 0.3),
                                    "s2": (0.0857, 0.07)}),
    ("blocker", None, 8000, 2500, 2, {"d": (-0.2556, 0.05),
                                      "delta_new": (-0.2501, 0.08)}),
    ("oxford", None, 9000, 3000, 2, {"alpha": (0.5658, 0.12),
                                     "beta1": (-0.0433, 0.025)}),
    ("salm", None, 8000, 2500, 2, {"alpha": (2.010, 0.35),
                                   "beta": (0.3543, 0.1),
                                   "s2": (0.0691, 0.05)}),
    ("epil", None, 8000, 2500, 2, {"alpha_Base": (0.9110, 0.15),
                                   "alpha_Trt": (-0.7593, 0.4),
                                   "s2_b1": (0.2491, 0.1),
                                   "s2_b": (0.1352, 0.06)}),
    ("stacks", None, 6000, 2000, 2, {"b[1]": (0.8369, 0.08),
                                     "b0": (-38.777, 3.0),
                                     "sigma": (3.488, 0.5),
                                     "outlier[21]": (0.60, 0.25)}),
    ("leuk", None, 6000, 2000, 2, {"beta": (1.5521, 0.25),
                                   "S_treat[1]": (0.9830, 0.02),
                                   "S_treat[10]": (0.7718, 0.06)}),
    ("mice", None, 6000, 2500, 2, {"r": (3.27, 0.45),
                                   "median[1]": (22.8, 1.5),
                                   "median[2]": (26.5, 1.8)}),
    ("dogs", None, 6000, 2000, 2, {"alpha": (-0.2442, 0.02),
                                   "beta": (-0.0789, 0.01),
                                   "A": (0.7836, 0.015),
                                   "B": (0.9242, 0.01)}),
    ("magnesium", None, 8000, 2500, 2, {"tau[6]": (0.568, 0.12),
                                        "OR[1]": (0.478, 0.12),
                                        "OR[3]": (0.431, 0.12)}),
    ("bones", None, 5000, 2000, 2, {"theta[1]": (0.3260, 0.15),
                                    "theta[5]": (5.5443, 0.5),
                                    "theta[13]": (16.9303, 0.8)}),
    ("equiv", None, 8000, 2500, 2, {"mu": (1.4387, 0.05),
                                    "theta": (1.0003, 0.1),
                                    "pi_": (-0.1874, 0.1)}),
    ("lsat", None, 3000, 1500, 1, {"beta": (0.8040, 0.08),
                                   "a[1]": (-1.2624, 0.08),
                                   "a[3]": (1.2421, 0.08)}),
    ("inhalers", None, 5000, 1500, 2, {"beta": (0.98, 0.3),
                                       "kappa": (0.25, 0.2),
                                       "pi_": (-0.22, 0.2)}),
]


#: epil's AMWG block mixes slowly in alpha_Trt: at this depth the chain means
#: spread by ~0.25 around -0.9 in both packages (16 chains each), so two
#: chains land outside the +-0.4 gate about one time in ten; eight do not
GOLDEN_CHAINS = {"epil": 8}


@pytest.mark.slow
@pytest.mark.parametrize("name,scheme,iters,burnin,thin,gates", GOLDEN_RUNS,
                         ids=[g[0] for g in GOLDEN_RUNS])
def test_golden(name, scheme, iters, burnin, thin, gates):
    tmod, _ = _mods(name)
    model, inputs, inits = _build(tmod, scheme)
    sim = tmt.mcmc(model, inputs, inits, iters, burnin=burnin, thin=thin,
                   chains=GOLDEN_CHAINS.get(name, 2), verbose=False,
                   device="cpu")
    s = tmt.summarystats(sim).to_dict()
    for label, (mean, tol) in gates.items():
        assert abs(s[label]["Mean"] - mean) < tol, (label, s[label]["Mean"])
    if name == "stacks":
        assert [n for n in sim.names if n.startswith("outlier")] == \
            ["outlier[1]", "outlier[3]", "outlier[4]", "outlier[21]"]
    if name == "inhalers":  # cutpoints stay ordered draw by draw
        idx = [sim.names.index(a) for a in ("a1", "a2", "a3")]
        a = sim.value[:, idx, :]
        assert np.all(a[:, 0] <= a[:, 1]) and np.all(a[:, 1] <= a[:, 2])


@pytest.mark.slow
def test_kidney_runs_and_is_sane():
    # the JAX package's test of the same name: kidney.rst has no golden
    # table, so the posterior is held to sign and stability features
    from mamba_tpu_torch.models import kidney
    model, inputs, inits = kidney.build()
    sim = tmt.mcmc(model, inputs, [inits[0]], 400, burnin=150, thin=1,
                   chains=2, verbose=False, device="cpu")
    s = tmt.summarystats(sim).to_dict()
    assert np.isfinite(tmt.summarystats(sim).value[:, 0, :]).all()
    assert s["beta_sex"]["Mean"] < 0       # female protective effect
    assert 0.5 < s["r"]["Mean"] < 2.5      # Weibull shape near 1.2
    assert s["s2"]["Mean"] > 0
