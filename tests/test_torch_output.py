"""The port's output layer against the JAX package's: the four convergence
diagnostics and the link transforms, model-based statistics (log-density
over stored draws, DIC, predictive draws), chain files with restart, CODA
import, ``cat``, and the top-level names.

Both packages get the same numpy inputs: iid numpy chains, and the draws
and final states of one JAX ``line`` run (thin 2, 3 chains) carried into a
port ``ModelChains`` by ``utils.convert.model_chains``.  Deterministic
tables agree at rtol 1e-10 in float64.  Predictive draws come from two
different generators, so they agree in distribution."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.models import line as jline
from mamba_tpu.output import diagnostics as jdiag
from mamba_tpu_torch.models import line as tline
from mamba_tpu_torch.output import diagnostics as tdiag
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

RTOL = 1e-10


def _iid(pkg, n=2000, p=2, m=3, seed=0):
    rng = np.random.default_rng(seed)
    return pkg.Chains(rng.normal(0, 1, (n, p, m)) + 2.5, start=1, thin=1,
                      names=[f"x{i}" for i in range(p)])


def _port_chains(jsim, model, inputs):
    """A JAX run's draws, final state and tunes as a port ModelChains."""
    tunes = [jax.tree_util.tree_map(np.asarray, t) for t in jsim.states["tunes"]]
    state = {k: np.asarray(v) for k, v in jsim.states["state"].items()}
    return convert.model_chains(
        jsim.value, model, inputs, state, tunes, start=jsim.start,
        thin=jsim.thin, names=jsim.names, chains=jsim.chains, iter=jsim.iter,
        burnin=jsim.states["burnin"], device="cpu")


@pytest.fixture(scope="module")
def runs():
    """(JAX line run, the same draws as a port ModelChains)."""
    model, inputs, inits = jline.build()
    jsim = jmt.mcmc(model, inputs, inits, 1000, burnin=200, thin=2, chains=3,
                    verbose=False)
    tmodel, tinputs, _ = tline.build()
    return jsim, _port_chains(jsim, tmodel, tinputs)


def _pair(kind, runs):
    if kind == "iid":
        return _iid(jmt), _iid(tmt)
    return runs


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(t, float), np.asarray(j, float),
                               rtol=rtol, atol=1e-12)


# -- diagnostics and link ----------------------------------------------------

DIAGNOSTICS = {
    "gelman": lambda pkg, c: pkg.gelmandiag(c, mpsrf=True, transform=True),
    "gelman_raw": lambda pkg, c: pkg.gelmandiag(c),
    "geweke": lambda pkg, c: pkg.gewekediag(c),
    "heidel": lambda pkg, c: pkg.heideldiag(c),
    "raftery": lambda pkg, c: pkg.rafterydiag(c, q=0.5, r=0.05),
}


@pytest.mark.parametrize("kind", ["iid", "line"])
@pytest.mark.parametrize("diag", sorted(DIAGNOSTICS))
def test_diagnostic_tables_match(diag, kind, runs):
    jc, tc = _pair(kind, runs)
    j = DIAGNOSTICS[diag](jmt, jc)
    t = DIAGNOSTICS[diag](tmt, tc)
    assert (t.rownames, t.colnames) == (j.rownames, j.colnames)
    assert t.header == j.header
    _close(t.value, j.value)


@pytest.mark.parametrize("kind", ["iid", "line"])
def test_link_values_match(kind, runs):
    jc, tc = _pair(kind, runs)
    _close(tdiag.link_values(tc), jdiag.link_values(jc))
    _close(tc.link(), jc.link())


def test_raftery_needs_nmin_draws(runs):
    # default q/r need 3,746 draws; 400 stored -> NaN in both packages
    jc, tc = runs
    assert np.all(np.isnan(tmt.rafterydiag(tc).value[:, 4, :]))
    _close(tmt.rafterydiag(tc).value[:, 3, :], jmt.rafterydiag(jc).value[:, 3, :])


def test_scalar_diagnostics_match():
    rng = np.random.default_rng(3)
    x = rng.normal(5, 0.5, 4000)
    for name in ("gewekediag_vec", "heideldiag_vec", "rafterydiag_vec"):
        _close(getattr(tdiag, name)(x), getattr(jdiag, name)(x))
    q = [0.05, 0.2, 0.5, 1.0, 2.0]
    _close([tdiag.pcramer(v) for v in q], [jdiag.pcramer(v) for v in q])


def test_gelman_needs_two_chains_and_sees_a_stuck_chain():
    with pytest.raises(ValueError):
        tmt.gelmandiag(_iid(tmt, m=1))
    c = _iid(tmt)
    c.value[:, 0, 0] += 5.0
    g = tmt.gelmandiag(c).value[:, 0, 0]
    assert g[0] > 1.5 and abs(g[1] - 1.0) < 0.05


def _bounded_pair():
    """theta ~ Uniform(2, 8): every draw is positive, so the heuristic
    would log it; its link is the scaled logit."""
    def build(pkg):
        ones = np.ones(3)
        model = pkg.Model(
            y=pkg.Stochastic(1, lambda theta: pkg.Normal(theta * ones, 1.0),
                             monitor=False),
            theta=pkg.Stochastic(lambda: pkg.Uniform(2.0, 8.0)))
        model.set_samplers([pkg.Slice("theta", 2.0)])
        return model
    inits = {"y": np.array([4.0, 5.0, 4.5]), "theta": 5.0}
    jsim = jmt.mcmc(build(jmt), {}, [inits], 300, burnin=100, chains=4,
                    verbose=False)
    return jsim, _port_chains(jsim, build(tmt), {})


def test_modelchains_link_uses_the_node_transform():
    jsim, tsim = _bounded_pair()
    linked = tsim.link()
    _close(linked, jsim.link())
    x = tsim.value[:, 0, :]
    p = (x - 2.0) / 6.0
    _close(linked[:, 0, :], np.log(p) - np.log1p(-p), rtol=1e-9)
    heur = tmt.Chains(tsim.value, start=tsim.start, thin=tsim.thin,
                      names=tsim.names).link()
    _close(heur[:, 0, :], np.log(x))
    _close(tmt.gelmandiag(tsim, transform=True).value,
           jmt.gelmandiag(jsim, transform=True).value)
    assert tsim.keys("monitor") == ["theta"] and tsim.keys("observed") == []


# -- model-based statistics --------------------------------------------------

def test_logpdf_chains_matches(runs):
    jsim, tsim = runs
    t, j = tmt.logpdf_chains(tsim), jmt.logpdf_chains(jsim)
    assert t.names == ["logpdf"] and t.value.shape == (jsim.niter, 1, 3)
    assert (t.start, t.thin, t.chains) == (j.start, j.thin, j.chains)
    _close(t.value, j.value)
    _close(tmt.logpdf_chains(tsim, "y").value, jmt.logpdf_chains(jsim, "y").value)


def test_logpdf_at_and_dic_match(runs):
    from mamba_tpu.output.modelstats import logpdf_at as jat
    from mamba_tpu_torch.output.modelstats import logpdf_at as tat
    jsim, tsim = runs
    for f in (np.mean, np.median):
        _close(tat(tsim, f), jat(jsim, f))
    t, j = tmt.dic(tsim), jmt.dic(jsim)
    assert t.rownames == ["pD", "pV"] and t.colnames == j.colnames
    _close(t.value, j.value)


def test_predict_matches_in_distribution(runs):
    jsim, tsim = runs
    t, j = tmt.predict(tsim, seed=1), jmt.predict(jsim, seed=1)
    assert t.names == j.names == [f"y[{i}]" for i in range(1, 6)]
    assert t.value.shape == j.value.shape
    assert (t.start, t.thin, t.chains) == (j.start, j.thin, j.chains)
    # 1,200 draws each: means within 5 standard errors of each other
    tv, jv = t.combine(), j.combine()
    se = np.sqrt(tv.var(0) / len(tv) + jv.var(0) / len(jv))
    assert np.all(np.abs(tv.mean(0) - jv.mean(0)) < 5 * se)
    np.testing.assert_allclose(tv.mean(0), [1.4, 2.2, 3.0, 3.8, 4.6], atol=0.8)
    # the generator is the caller's seed, not a global one
    before = torch.random.get_rng_state()
    np.testing.assert_array_equal(tmt.predict(tsim, seed=1).value, t.value)
    assert torch.equal(before, torch.random.get_rng_state())
    with pytest.raises(ValueError):
        tmt.predict(tsim, ["beta"])


def test_model_stats_need_every_sampled_node_monitored():
    from mamba_tpu_torch.models import glmm
    model, inputs, inits, _ = glmm.build(G=6, n=3, seed=1, fused=True)
    sim = tmt.mcmc(model, inputs, inits, 4, burnin=2, chains=2, verbose=False,
                   device="cpu")
    with pytest.raises(ValueError, match="not monitored"):
        tmt.dic(sim)


def test_the_fused_kernel_sees_one_flattened_batch(monkeypatch):
    """logpdf_chains over C chains x n draws of a fused GLMM is one call of
    the kernel Function's vmap rule with batch C*n: no nested vmap, whose
    inner level would hand the CUDA kernel batched tensors."""
    from mamba_tpu_torch.models import glmm
    from mamba_tpu_torch.ops import fused_glmm as fg
    model, inputs, inits, _ = glmm.build(G=6, n=3, seed=1, fused=True)
    model.nodes["z"] = dataclasses.replace(model.nodes["z"], monitor=True)
    sim = tmt.mcmc(model, inputs, inits, 7, burnin=2, chains=3, verbose=False,
                   device="cpu")
    calls = []
    inner = fg.glmm_loglik_grads

    def counting(Xt, y, betas, bs):
        calls.append(betas.shape[0])
        return inner(Xt, y, betas, bs)

    monkeypatch.setattr(fg, "glmm_loglik_grads", counting)
    lp = tmt.logpdf_chains(sim)
    assert calls == [3 * 5]
    model_g, inputs_g, _, _ = glmm.build(G=6, n=3, seed=1, fused=False)
    model_g.nodes["z"] = dataclasses.replace(model_g.nodes["z"], monitor=True)
    state = {k: v.numpy() for k, v in sim.states["state"].items()}
    state["y"] = np.swapaxes(state["y"], 1, 2)        # (n, G) -> (G, n)
    plain = convert.model_chains(sim.value, model_g, inputs_g, state,
                                 start=sim.start, names=sim.names, device="cpu")
    _close(lp.value, tmt.logpdf_chains(plain).value)
    _close(tmt.dic(sim).value, tmt.dic(plain).value)


# -- files ---------------------------------------------------------------------

def test_write_read_roundtrip(tmp_path, runs):
    jsim, tsim = runs
    path = os.path.join(tmp_path, "sim.pkl")
    tmt.write_chains(path, tsim)
    c = tmt.read_chains(path)
    assert type(c) is tmt.Chains
    np.testing.assert_array_equal(c.value, tsim.value)
    assert (c.names, c.start, c.thin, c.chains) == (
        tsim.names, tsim.start, tsim.thin, tsim.chains)
    with pytest.raises(ValueError, match="explicit device"):
        tmt.read_chains(path, tline.build()[0], tline.build()[1])
    with pytest.raises(ValueError, match="generator"):
        tmt.read_chains(path, tline.build()[0], tline.build()[1], device="meta")


def test_restart_from_a_file_equals_the_in_memory_restart(tmp_path):
    model, inputs, inits = tline.build()
    sim = tmt.mcmc(model, inputs, inits, 60, burnin=20, thin=2, chains=2,
                   verbose=False, device="cpu")
    path = os.path.join(tmp_path, "sim.pkl")
    tmt.write_chains(path, sim)
    model2, inputs2, _ = tline.build()
    mc = tmt.read_chains(path, model2, inputs2, device="cpu")
    assert mc.iter == sim.iter and mc.compiled.dtype == torch.float64
    a = tmt.mcmc(mc, 20, verbose=False)
    b = tmt.mcmc(sim, 20, verbose=False)
    np.testing.assert_array_equal(a.value, b.value)
    np.testing.assert_array_equal(a.value[:sim.niter], sim.value)
    assert a.niter == sim.niter + 10 and a.iter == sim.iter + 20
    assert np.all(np.diff(a.range) == 2) and a.range[sim.niter] == sim.iter + 2
    for k in a.states["state"]:
        assert torch.equal(a.states["state"][k], b.states["state"][k])


def test_restart_of_a_converted_reference_run(runs):
    jsim, tsim = runs
    out = tmt.mcmc(tsim, 10, verbose=False)
    np.testing.assert_array_equal(out.value[:jsim.niter], jsim.value)
    assert out.range[-1] == jsim.iter + 10 and np.isfinite(out.value).all()


def test_readcoda_matches(tmp_path):
    it = np.arange(1, 101)
    out = os.path.join(tmp_path, "coda1.txt")
    ind = os.path.join(tmp_path, "codaIndex.txt")
    with open(out, "w") as f:
        for v in (np.sin(it / 10.0), np.cos(it / 10.0)):
            for i, x in zip(it, v):
                f.write(f"{i}  {x:.6f}\n")
    with open(ind, "w") as f:
        f.write("alpha 1 100\nbeta 101 200\n")
    t, j = tmt.readcoda(out, ind), jmt.readcoda(out, ind)
    assert (t.names, t.start, t.thin) == (j.names, j.start, j.thin)
    assert t.value.shape == (100, 2, 1)
    np.testing.assert_array_equal(t.value, j.value)


# -- cat, names ------------------------------------------------------------------

def test_cat_chains_params_iterations():
    model, inputs, inits = tline.build()
    a, b, c = (tmt.mcmc(model, inputs, inits, 30, burnin=10, chains=2, seed=s,
                        verbose=False, device="cpu") for s in (1, 2, 3))
    out = a.cat(3, b, c)
    assert out.nchains == 6 and out.chains == list(range(1, 7))
    np.testing.assert_array_equal(out.value[:, :, 2:4], b.value)
    with pytest.raises(ValueError):
        a.cat(1, b)
    more = tmt.mcmc(a, 10, verbose=False)
    both = a.cat(1, more[31:, :, :])
    assert both.range[-1] == 40
    np.testing.assert_array_equal(both.value, more.value)
    x = tmt.Chains(a.value[:, :1], names=["u"]).cat(2, tmt.Chains(a.value[:, 1:2], names=["v"]))
    assert x.names == ["u", "v"]


def test_top_level_names_are_the_reference_s_but_parallel():
    import mamba_tpu.parallel as jpar

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")}

    # parallel came last (chain sharding): the port now has every name
    assert public(jmt) - public(tmt) == set()
    assert tmt.parallel.__all__ == jpar.__all__
