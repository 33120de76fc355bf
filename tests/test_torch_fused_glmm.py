"""The port's fused GLMM likelihood (mamba_tpu_torch.ops.fused_glmm) against
the JAX package's: the plain torch version and its autograd/vmap wrapper
must agree with ``reference_loglik`` and the Pallas kernel (interpret mode
on the CPU) in float64.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.ops import fused_glmm as jfg
from mamba_tpu_torch.ops import fused_glmm as tfg

torch.set_num_threads(2)


def _data(G=37, n=5, P=4, C=1, seed=0):
    rng = np.random.default_rng(seed)
    Xt = rng.normal(0, 1, (P, n, G))
    y = (rng.random((n, G)) < 0.5).astype(float)
    betas = rng.normal(0, 1, (C, P))
    bs = rng.normal(0, 0.7, (C, G))
    return Xt, y, betas, bs


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_plain_matches_jax_reference_and_kernel():
    Xt, y, betas, bs = _data()      # G=37: the JAX kernel's lane-padding path
    lp, gbeta, gb = tfg.glmm_loglik_grads_plain(_t(Xt), _t(y), _t(betas), _t(bs))
    beta, b = jnp.asarray(betas[0]), jnp.asarray(bs[0])
    for f in (jfg.reference_loglik, jfg.bernoulli_logit_glmm_loglik):
        val, (g_beta, g_b) = jax.value_and_grad(
            lambda be, bb: f(jnp.asarray(Xt), jnp.asarray(y), be, bb),
            argnums=(0, 1))(beta, b)
        np.testing.assert_allclose(lp[0].item(), float(val), rtol=1e-9)
        np.testing.assert_allclose(gbeta[0].numpy(), np.asarray(g_beta), rtol=1e-9)
        np.testing.assert_allclose(gb[0].numpy(), np.asarray(g_b), rtol=1e-9)


def test_autograd_function_gives_value_and_both_gradients():
    Xt, y, betas, bs = _data(G=16)
    beta = _t(betas[0]).requires_grad_()
    b = _t(bs[0]).requires_grad_()
    d = tfg.BernoulliLogitGLMM(_t(Xt), beta, b)
    lp = d.log_prob(_t(y))
    g_beta, g_b = torch.autograd.grad(2.0 * lp, (beta, b))
    ref = tfg.glmm_loglik_grads_plain(_t(Xt), _t(y), _t(betas), _t(bs))
    np.testing.assert_allclose(lp.item(), ref[0][0].item(), rtol=1e-12)
    np.testing.assert_allclose(g_beta.numpy(), 2.0 * ref[1][0].numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_b.numpy(), 2.0 * ref[2][0].numpy(), rtol=1e-12)


def test_vmap_grad_and_value_is_one_batched_call(monkeypatch):
    C, G = 6, 16
    Xt, y, betas, bs = _data(G=G, C=C, seed=3)
    calls = []
    inner = tfg.glmm_loglik_grads

    def counting(*args):
        calls.append(tuple(a.shape for a in args))
        return inner(*args)

    monkeypatch.setattr(tfg, "glmm_loglik_grads", counting)
    ys = _t(np.broadcast_to(y, (C,) + y.shape).copy())   # chain-stacked data

    def f(beta, b, yy):
        return tfg.BernoulliLogitGLMM(_t(Xt), beta, b).log_prob(yy)

    grads, vals = torch.func.vmap(torch.func.grad_and_value(f))(
        _t(betas), _t(bs), ys)
    assert calls == [((4, 5, G), (5, G), (C, 4), (C, G))]

    jf = jax.vmap(jax.value_and_grad(
        lambda be, bb: jfg.bernoulli_logit_glmm_loglik(
            jnp.asarray(Xt), jnp.asarray(y), be, bb)))
    jvals, jgrads = jf(jnp.asarray(betas), jnp.asarray(bs))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-9)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-9)


def test_vmap_rule_rejects_batched_covariates():
    Xt, y, betas, bs = _data(G=8, C=2)
    Xts = _t(np.broadcast_to(Xt, (2,) + Xt.shape).copy())
    with pytest.raises(NotImplementedError, match="covariates"):
        torch.func.vmap(lambda xt, be, bb: tfg.bernoulli_logit_glmm_loglik.apply(
            xt, _t(y), be, bb)[0])(Xts, _t(betas), _t(bs))


def test_wrapper_raises_off_cpu_instead_of_falling_back():
    # a tensor that is not on the CPU must reach the kernel or fail: here a
    # device that has no kernel at all
    Xt, y, betas, bs = _data(G=8, C=2)
    args = [_t(a).to("meta") for a in (Xt, y, betas, bs)]
    before = tfg.glmm_loglik_grads.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfg.glmm_loglik_grads(*args)
    assert tfg.glmm_loglik_grads.launches == before


def test_in_support_rejects_nonbinary():
    Xt, y, betas, bs = _data(G=16)
    d = tfg.BernoulliLogitGLMM(_t(Xt), _t(betas[0]), _t(bs[0]))
    jd = jfg.BernoulliLogitGLMM(jnp.asarray(Xt), jnp.asarray(betas[0]),
                                jnp.asarray(bs[0]))
    bad = y.copy()
    bad[0, 0] = 0.5
    assert bool(d.in_support(_t(y))) and not bool(d.in_support(_t(bad)))
    assert np.isneginf(d.total_log_prob(_t(bad)).item())
    np.testing.assert_allclose(d.total_log_prob(_t(y)).item(),
                               float(jd.total_log_prob(jnp.asarray(y))),
                               rtol=1e-10)


def test_fused_rejects_miss_nan_data():
    from mamba_tpu_torch.models import glmm
    model, inputs, inits, _ = glmm.build(G=16, n=5, seed=3, fused=True)
    y = np.asarray(inits[0]["y"], dtype=float).copy()
    y[0, 0] = np.nan
    with pytest.raises(ValueError, match="fused|supports_imputation|chain 0"):
        tmt.mcmc(model, inputs, [dict(inits[0], y=y)], 10, burnin=2,
                 chains=2, verbose=False, device="cpu")
    # and the JAX package says the same
    jmodel, jinputs, jinits, _ = jmt.models.glmm.build(G=16, n=5, seed=3,
                                                       fused=True)
    with pytest.raises(ValueError, match="fused|supports_imputation|chain 0"):
        jmt.mcmc(jmodel, jinputs, [dict(jinits[0], y=y)], 10, burnin=2,
                 chains=2, verbose=False)
