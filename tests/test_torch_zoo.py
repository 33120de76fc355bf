"""The port's model zoo against the JAX package's, model by model: data,
inits and GOLDEN are equal; the joint density, the monitored logical nodes
and every sampler block's density and gradient agree at the same seeded
chain states, rtol 1e-10 in float64 (the same terms; sums may be taken in
another order).  gk's data node has no density (its distribution has only
``sample`` and ``quantile``): there the joint density and the ABC blocks'
are their priors, ``prior_only``, and both packages refuse the full one.
One short engine run per model and scheme on the CPU; the golden runs are
marked slow, as their JAX counterparts are, and hold the gates of the JAX
package's golden tests."""

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
MULTIVARIATE = ("eyes", "asthma", "jaws", "birats", "pollution", "line_abc",
                "gk")
MODELS = REQUIRED + ("equiv", "lsat", "inhalers", "kidney") + MULTIVARIATE
#: every scheme a model's ``build`` offers
SCHEMES = [(m, None) for m in MODELS] + [
    (m, "nuts") for m in ("seeds", "oxford", "epil", "leuk", "equiv", "lsat")] + [
    ("pollution", s) for s in ("bmc3", "bmg", "dgs", "bia")]
#: models whose data node has no density
NO_LIKELIHOOD = ("gk",)


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
    their unconstrained space, so every state is inside its support, and
    sampled discrete sites drawn uniformly over their support.  inhalers'
    cutpoints, whose supports are each other's values on a (-1000, 1000)
    scale, move by N(0, 0.05) as they are."""
    rng = np.random.default_rng(seed)
    scale = NOISE.get(name, 0.1)
    state = _chain_inits(tcm, inits[0], C)
    sampled = {p for s in tcm.model.samplers if not isinstance(s, tmt.MISS)
               for p in s.params}
    out = {}
    for site, v in state.items():
        dist = tcm.example_dists[site]
        if name == "inhalers" and site in ("a1", "a2", "a3"):
            v = v + torch.as_tensor(rng.normal(0.0, 0.05, v.shape))
        elif site in sampled and dist.is_discrete:
            lo, hi = (np.broadcast_to(b.numpy(), v.shape[1:])
                      for b in dist.support_bounds())
            v = torch.as_tensor(rng.integers(lo, hi + 1, v.shape), dtype=v.dtype)
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


def _compiled(fn, *args):
    """``fn(*args)`` on the JAX side, compiled (op by op it takes seconds
    per model), or as it is where a function reads a bound on the host
    (``Truncated.bijector``) and cannot be traced."""
    try:
        return jax.jit(fn)(*args)
    except jax.errors.ConcretizationTypeError:
        return fn(*args)


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
    terms = None
    if name in NO_LIKELIHOOD:
        with pytest.raises(NotImplementedError):
            tcm.logpdf({k: v[0] for k, v in tst.items()})
        with pytest.raises(NotImplementedError):
            jcm.logpdf({k: v[0] for k, v in jst.items()})
        terms = tuple(p for s in tm.samplers for p in s.params)
    lp = torch.func.vmap(lambda st: tcm.logpdf(st, terms))(tst)
    jlp = _compiled(jax.vmap(lambda st: jcm.logpdf(st, terms)), jst)
    assert np.isfinite(np.asarray(jlp)).all()
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=RTOL)

    _, labels, pack_mon = tcm.monitor_spec()
    _, jlabels, jpack_mon = jcm.monitor_spec()
    assert labels == jlabels
    np.testing.assert_allclose(torch.func.vmap(pack_mon)(tst).numpy(),
                               np.asarray(_compiled(jax.vmap(jpack_mon), jst)),
                               rtol=RTOL, atol=1e-14)

    blocks = [s for s in tcm.model.samplers if not isinstance(s, tmt.MISS)]
    assert blocks
    for spec in blocks:
        prior = name in NO_LIKELIHOOD
        pack, unpack, _, logf = tcm.block_functions(spec.params, spec.transform,
                                                    prior_only=prior)
        jpack, _, _, jlogf = jcm.block_functions(spec.params, spec.transform,
                                                 prior_only=prior)
        x = torch.func.vmap(pack)(tst)
        jx = _compiled(jax.vmap(jpack), jst)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL,
                                   atol=1e-14, err_msg=repr(spec))
        back = torch.func.vmap(unpack)(x, tst)
        for p in spec.params:
            np.testing.assert_allclose(back[p].numpy(), states[p], rtol=RTOL,
                                       atol=1e-12, err_msg=p)
        grads, vals = torch.func.vmap(torch.func.grad_and_value(logf))(x, tst)
        jvals, jgrads = _compiled(jax.vmap(jax.value_and_grad(jlogf)), jx, jst)
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
    # all 28 models of the JAX package
    assert sorted(tmt.models.__all__) == sorted(jmt.models.__all__)
    assert len(tmt.models.__all__) == 28
    for name in tmt.models.__all__:
        assert hasattr(tmt.models, name)
    for name in MODELS:
        assert name in tmt.models.__all__


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


# ---- the multivariate models' golden runs (tests/test_models_golden.py) ----
# (model, scheme, iters, burnin, thin, chains, inits used, gates)
GOLDEN_MV = [
    ("eyes", None, 6000, 2000, 2, 2, None, {"P[1]": (0.6036, 0.08),
                                            "lam[1]": (536.753, 1.5),
                                            "lam[2]": (548.987, 1.5)}),
    ("asthma", None, 6000, 2000, 2, 3, None, {"q[1,1]": (0.7616, 0.04),
                                              "q[2,2]": (0.8544, 0.02),
                                              "q[3,1]": (0.2937, 0.12)}),
    ("jaws", None, 6000, 2000, 2, 2, None, {"beta1": (1.8743, 0.1),
                                            "Sigma[1,1]": (6.7916, 1.5),
                                            "Sigma[4,4]": (8.0594, 1.8)}),
    ("birats", None, 6000, 2000, 2, 2, None, {"mu_beta[1]": (106.70, 1.5),
                                              "mu_beta[2]": (6.180, 0.1),
                                              "sigmaC": (6.143, 0.4)}),
    ("line_abc", None, 2500, 500, 1, 2, 2, {"beta[1]": (0.7235, 0.4),
                                            "beta[2]": (0.7747, 0.15),
                                            "s2": (1.3074, 0.9)}),
    ("gk", None, 2000, 700, 1, 2, 2, {"A": (3.0037, 0.15), "B": (1.0576, 0.35),
                                      "g": (2.0259, 0.5), "k": (0.3511, 0.25)}),
]


@pytest.mark.slow
@pytest.mark.parametrize("name,scheme,iters,burnin,thin,chains,n_inits,gates",
                         GOLDEN_MV, ids=[g[0] for g in GOLDEN_MV])
def test_golden_multivariate(name, scheme, iters, burnin, thin, chains, n_inits,
                             gates):
    tmod, _ = _mods(name)
    model, inputs, inits = _build(tmod, scheme)
    sim = tmt.mcmc(model, inputs, inits[:n_inits], iters, burnin=burnin,
                   thin=thin, chains=chains, verbose=False, device="cpu")
    s = tmt.summarystats(sim).to_dict()
    for label, (mean, tol) in gates.items():
        assert abs(s[label]["Mean"] - mean) < tol, (label, s[label]["Mean"])
    if name in ("eyes", "asthma"):          # the simplexes stay inside
        node = "P" if name == "eyes" else "q"
        v = sim.value[:, [i for i, n in enumerate(sim.names)
                          if n.startswith(node + "[")], :]
        assert np.all((v > 0) & (v < 1))
    if name == "jaws":
        assert bool((torch.linalg.eigvalsh(sim.states["state"]["Sigma"]) > 0).all())


@pytest.mark.slow
def test_pollution_variable_selection():
    # the robust features of the reference's table (see the JAX test):
    # gamma[9] decisively in, gamma[2] uncertain to out.  gamma[2] sticks:
    # its chain means spread from 0.03 to 0.98 around 0.50 (the JAX package,
    # 16 chains), so two chains pass its < 0.6 gate only about two times in
    # three in either package; sixteen pass it nineteen times in twenty
    from mamba_tpu_torch.models import pollution
    model, inputs, inits = pollution.build("dgs")
    sim = tmt.mcmc(model, inputs, inits, 3000, burnin=1000, thin=2, chains=16,
                   verbose=False, device="cpu")
    s = tmt.summarystats(sim).to_dict()
    assert s["gamma[9]"]["Mean"] > 0.8
    assert s["gamma[2]"]["Mean"] < 0.6
    assert set(np.unique(sim.value)) <= {0.0, 1.0}


@pytest.mark.slow
@pytest.mark.parametrize("scheme", ["bhmc", "bmc3", "bmg", "bia"])
def test_pollution_binary_schemes_run(scheme):
    from mamba_tpu_torch.models import pollution
    model, inputs, inits = pollution.build(scheme)
    sim = tmt.mcmc(model, inputs, inits[:2], 400, burnin=150, thin=1, chains=2,
                   verbose=False, device="cpu")
    assert set(np.unique(sim.value)) <= {0.0, 1.0}
    # means finite; MCSE and ESS may be NaN for coordinates that never flip
    assert np.isfinite(tmt.summarystats(sim).value[:, 0, :]).all()
