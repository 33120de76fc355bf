"""The port's model layer against the JAX package at the same inputs, in
float64 on the CPU: bijectors, distributions, ravel specs and labels, the
GLMM's compiled log density and block gradients (fused and generic builds),
monitor labels and the posterior statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.ops import bijectors as jbij
from mamba_tpu.utils import pytree as jpt
from mamba_tpu_torch.ops import bijectors as tbij
from mamba_tpu_torch.utils import convert
from mamba_tpu_torch.utils import pytree as tpt

torch.set_num_threads(2)

RNG = np.random.default_rng(11)
U = RNG.normal(0, 1.5, (3, 4))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(t, j, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name, args, event_ndim", [
    ("Identity", (), 0), ("Exp", (), 0), ("LowerBounded", (-1.5,), 0),
    ("UpperBounded", (2.0,), 0), ("Sigmoid", (-1.0, 3.0), 0),
    ("StickBreaking", (), 1), ("Discrete", (), 0)])
def test_bijectors_match(name, args, event_ndim):
    tb = getattr(tbij, name)(*args)
    jb = getattr(jbij, name)(*[jnp.asarray(a) for a in args])
    x_t, x_j = tb.forward(_t(U)), jb.forward(jnp.asarray(U))
    _close(x_t, x_j)
    _close(tb.inverse(x_t), jb.inverse(x_j), atol=1e-9)
    _close(tb.event_log_det(_t(U), event_ndim),
           jb.event_log_det(jnp.asarray(U), event_ndim))


def test_cholesky_bijector_matches():
    u = RNG.normal(0, 0.5, (2, 6))
    tb, jb = tbij.CholeskyPD(3), jbij.CholeskyPD(3)
    x_t, x_j = tb.forward(_t(u)), jb.forward(jnp.asarray(u))
    _close(x_t, x_j)
    _close(tb.inverse(x_t), jb.inverse(x_j), atol=1e-9)
    _close(tb.event_log_det(_t(u), 2), jb.event_log_det(jnp.asarray(u), 2))


def test_distributions_match():
    x = RNG.normal(0, 2, (5,))
    pos = np.exp(x)
    y = (RNG.random(5) < 0.5).astype(float)
    p = RNG.random(5)
    pairs = [
        (tmt.Normal(_t(RNG.normal(size=5)), 1.7), jmt.Normal, x),
        (tmt.InverseGamma(2.5, _t(pos[::-1].copy())), jmt.InverseGamma, pos),
        (tmt.Bernoulli(_t(p)), jmt.Bernoulli, y),
    ]
    for d, jcls, v in pairs:
        jd = jcls(*[jnp.asarray(getattr(d, f).numpy()
                                if isinstance(getattr(d, f), torch.Tensor)
                                else getattr(d, f))
                    for f in d.__dataclass_fields__])
        _close(d.log_prob(_t(v)), jd.log_prob(jnp.asarray(v)))
        _close(d.total_log_prob(_t(v)), jd.total_log_prob(jnp.asarray(v)))
        assert type(d.bijector()).__name__ == type(jd.bijector()).__name__
    # out of support -> -inf, as in the reference
    assert np.isneginf(tmt.InverseGamma(2.0, 2.0).total_log_prob(_t([-1.0])).item())
    assert np.isneginf(tmt.Bernoulli(0.3).total_log_prob(_t([0.5])).item())


def test_ravel_spec_and_labels_match():
    ex = {"b": np.zeros((2, 3)), "a": np.zeros(4), "s": np.zeros(())}
    ts = tpt.make_ravel_spec(ex, torch.float64)
    js = jpt.make_ravel_spec(ex, dtype=jnp.float64)
    assert (ts.names, ts.shapes, ts.offsets, ts.total) == (
        js.names, js.shapes, js.offsets, js.total)
    tree = {k: RNG.normal(size=np.shape(v)) for k, v in ex.items()}
    flat = ts.ravel({k: _t(v) for k, v in tree.items()})
    _close(flat, js.ravel({k: jnp.asarray(v) for k, v in tree.items()}))
    back = ts.unravel(flat)
    for k, v in tree.items():
        _close(back[k], v)
    for shape in ((), (3,), (2, 3), (2, 2, 2)):
        assert tpt.elementwise_names("S", shape) == jpt.elementwise_names("S", shape)


def _glmm_pair(fused, centered, G=24, n=5, seed=1):
    tm, tin, tinit, _ = tmt.models.glmm.build(G=G, n=n, seed=seed, fused=fused,
                                              centered=centered)
    jm, jin, jinit, _ = jmt.models.glmm.build(G=G, n=n, seed=seed, fused=fused,
                                              centered=centered)
    for k in tin:
        np.testing.assert_array_equal(tin[k], jin[k])   # same data from seed
    tcm = tmt.compile_model(tm, tin, tinit[0], device="cpu")
    jcm = jmt.compile_model(jm, jin, jinit[0])
    return tcm, jcm, tinit[0]["y"]


def _states(G, y, C=3, centered=False, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(C):
        st = {"beta": rng.normal(0, 1, 4), "s2": np.exp(rng.normal(0, 0.3)),
              "y": np.asarray(y, dtype=float)}
        st["b" if centered else "z"] = rng.normal(0, 1, G)
        out.append(st)
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("centered", [False, True])
def test_glmm_logpdf_and_block_gradients_match(fused, centered):
    G = 24
    tcm, jcm, y = _glmm_pair(fused, centered, G=G)
    states = _states(G, y, centered=centered)
    params = ("beta", "b") if centered else ("beta", "z", "s2")
    # full log density at each state
    for st in states:
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        _close(tcm.logpdf(convert.to_tensors(st, "cpu", torch.float64)),
               jcm.logpdf(jst))
    # the NUTS block's value and gradient, batched over chains as the
    # engine evaluates them
    tpack, _, _, tlogf = tcm.block_functions(params, True)
    jpack, _, _, jlogf = jcm.block_functions(params, True)
    tst = convert.to_tensors({k: np.stack([s[k] for s in states])
                              for k in states[0]}, "cpu", torch.float64)
    x = torch.func.vmap(tpack)(tst)
    grads, vals = torch.func.vmap(torch.func.grad_and_value(tlogf))(x, tst)
    for c, st in enumerate(states):
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        jflat = jpack(jst)
        _close(x[c], jflat)
        jval, jgrad = jax.value_and_grad(jlogf)(jflat, jst)
        _close(vals[c], jval)
        _close(grads[c], jgrad)


@pytest.mark.parametrize("fused", [False, True])
def test_masked_observations_match(fused):
    # likelihood masks: masked entries add exactly 0 (per element for the
    # generic Bernoulli; whole events for the fused node's one (n, G)
    # event).  A mask that takes part of that event drops the whole
    # likelihood in the JAX package (ROADMAP Queue 3); the port refuses it
    # (tests/test_torch_parallel.py holds the group ranges it takes).
    G, n = 24, 5
    tm, tin, tinit, _ = tmt.models.glmm.build(G=G, n=n, seed=1, fused=fused)
    jm, jin, jinit, _ = jmt.models.glmm.build(G=G, n=n, seed=1, fused=fused)
    y = tinit[0]["y"]
    partial = np.random.default_rng(3).random(y.shape) < 0.7
    for mask in ((partial,) if not fused else ()) + (np.ones(y.shape, bool),
                                                      np.zeros(y.shape, bool)):
        tcm = tmt.compile_model(tm, tin, tinit[0], device="cpu",
                                masks={"y": mask})
        jcm = jmt.compile_model(jm, jin, jinit[0], masks={"y": mask})
        st = _states(G, y, C=1)[0]
        _close(tcm.logpdf(convert.to_tensors(st, "cpu", torch.float64)),
               jcm.logpdf({k: jnp.asarray(v) for k, v in st.items()}))
    if fused:
        with pytest.raises(ValueError, match="takes part of an event"):
            tmt.compile_model(tm, tin, tinit[0], device="cpu",
                              masks={"y": partial})


def test_monitor_labels_match():
    for fused in (False, True):
        tcm, jcm, _ = _glmm_pair(fused, False)
        tnames, tlabels, _ = tcm.monitor_spec()
        jnames, jlabels, _ = jcm.monitor_spec()
        assert (tnames, tlabels) == (jnames, jlabels)


def test_compile_needs_explicit_device():
    model, inputs, inits, _ = tmt.models.glmm.build(G=8, n=2)
    with pytest.raises(TypeError):
        tmt.compile_model(model, inputs, inits[0])
    with pytest.raises(ValueError, match="device"):
        tmt.mcmc(model, inputs, inits, 10, burnin=2, verbose=False)


def test_stats_match_on_same_arrays():
    v = np.random.default_rng(5).normal(size=(200, 3, 4)).cumsum(0)
    tc = tmt.Chains(v, start=11, thin=2, names=["a", "b[1]", "b[2]"])
    jc = jmt.Chains(v, start=11, thin=2, names=["a", "b[1]", "b[2]"])
    np.testing.assert_allclose(tmt.summarystats(tc).value,
                               jmt.summarystats(jc).value, rtol=1e-12)
    np.testing.assert_allclose(tmt.rhat_rank(v), jmt.rhat_rank(v), rtol=1e-12)
    np.testing.assert_allclose(tmt.ess_bulk(v), jmt.ess_bulk(v), rtol=1e-12)
