"""The port's fused GLMM likelihood (mamba_tpu_torch.ops.fused_glmm) against
the JAX package's: the plain torch version and its autograd/vmap wrapper
must agree with ``reference_loglik`` and the Pallas kernel (interpret mode
on the CPU) in float64.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.ops import fused_glmm as jfg
from mamba_tpu_torch.ops import fused_glmm as tfg
from mamba_tpu_torch.scripts import glmm_cases

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


# --- the call's work and its bound on an H100 -------------------------------

@pytest.mark.parametrize("shape, want", [
    # the main path: 83.9 MB, 2.87 GFLOP, 307.2 M special-function results
    (dict(P=4, n=10, G=10_000, C=1024),
     dict(bytes=83.9e6, flops=2.87e9, sfu=307.2e6)),
    # P = 3, n = 7, counted by hand: N = 33 * 7 * 300 observations, 24 float32
    # operations each; floats moved: Xt 6300, y 2100, betas 99, bs 9900,
    # lp 33, gbeta 99, gb 9900
    (dict(P=3, n=7, G=300, C=33),
     dict(bytes=4 * 28_431, flops=24 * 69_300, sfu=3 * 69_300)),
])
def test_glmm_work_counts_bytes_flops_and_special_functions(shape, want):
    work = tfg.glmm_work(**shape)
    for key, value in want.items():
        # the main path's figures are quoted to three or four digits
        np.testing.assert_allclose(work[key], value, rtol=2e-3)


def test_glmm_bound_is_the_largest_of_three_floors():
    b = tfg.glmm_bound_ms(4, 10, 10_000, 1024, sm_clock_hz=1.98e9)
    np.testing.assert_allclose(
        [b["memory_ms"], b["fp32_ms"], b["sfu_ms"]],
        [0.02506, 0.04279, 0.07346], rtol=1e-3)
    # three special-function results are the kernel's count, not the least:
    # with a polynomial logarithm (two results, 14 more float32 operations)
    # float32 binds, below the kernel's special-function floor.  The bound
    # is the cheaper form's largest floor.
    np.testing.assert_allclose(
        [b["poly_log_fp32_ms"], b["poly_log_sfu_ms"]], [0.06419, 0.04897],
        rtol=1e-3)
    assert b["bound_by"] == "fp32" and b["bound_ms"] == b["poly_log_fp32_ms"]
    assert b["bound_ms"] < b["sfu_ms"]
    # at a clock where the special-function pipe outruns float32 the kernel's
    # own form is the cheaper one, and its float32 floor binds
    fast = tfg.glmm_bound_ms(4, 10, 10_000, 1024, sm_clock_hz=4e9)
    assert fast["bound_by"] == "fp32" and fast["bound_ms"] == fast["fp32_ms"]
    # at a low clock the polynomial form still has two results to wait for
    slow = tfg.glmm_bound_ms(4, 10, 10_000, 1024, sm_clock_hz=1e9)
    assert slow["bound_by"] == "sfu"
    assert slow["bound_ms"] == slow["poly_log_sfu_ms"]
    # one observation per (chain, group) and 8 fixed effects: b and gb are
    # used once each, so memory binds at any clock the card reaches
    wide = tfg.glmm_bound_ms(8, 1, 10_000, 1024, sm_clock_hz=1.98e9)
    assert wide["bound_by"] == "memory" and wide["bound_ms"] == wide["memory_ms"]


# --- the near-mode case ------------------------------------------------------

def test_near_mode_inputs_are_deterministic_and_cancel():
    G, C = 2000, 3
    first = glmm_cases.near_mode_inputs(G, C, seed=7)
    again = glmm_cases.near_mode_inputs(G, C, seed=7)
    other = glmm_cases.near_mode_inputs(G, C, seed=8)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[3], other[3])
    Xt, y, betas, bs = first
    assert (Xt.shape, y.shape, betas.shape, bs.shape) == (
        (4, 10, G), (10, G), (C, 4), (C, G))
    # grad_beta = sum r X cancels to far below the sum of its terms' sizes
    l = np.einsum("pig,cp->cig", Xt, betas) + bs[:, None, :]
    r = y - 1 / (1 + np.exp(-l))
    total = np.abs(np.einsum("cig,pig->cp", r, Xt))
    sizes = np.einsum("cig,pig->cp", np.abs(r), np.abs(Xt))
    assert (total < 0.05 * sizes).all()


def test_near_mode_float32_plain_matches_float64_and_jax():
    # float32 against float64 on a cancelling sum: the gates chip_smoke.py
    # holds the kernel to (gradient error <= 1e-4 of the gradient scale, lp
    # <= 1e-5 relative).  float32 rounding of 2e4 terms of size <= 1 leaves
    # about 1e-6 of the scale, so the gate has two digits to spare.
    G, C = 2000, 2
    arrays = glmm_cases.near_mode_inputs(G, C, seed=0)
    ref = tfg.glmm_loglik_grads_plain(*(_t(a) for a in arrays))
    out = tfg.glmm_loglik_grads_plain(
        *(torch.as_tensor(a, dtype=torch.float32) for a in arrays))
    err = glmm_cases.glmm_errors(out, ref)
    assert err["lp_rel_err"] <= 1e-5 and err["grad_rel_err"] <= 1e-4
    assert err["gbeta_rel_err"] <= 1e-4

    Xt, y, betas, bs = (jnp.asarray(a) for a in arrays)
    jf = jax.vmap(jax.value_and_grad(
        lambda be, bb: jfg.bernoulli_logit_glmm_loglik(Xt, y, be, bb),
        argnums=(0, 1)))
    jlp, (jgbeta, jgb) = jf(betas, bs)
    jref = tuple(_t(np.array(a)) for a in (jlp, jgbeta, jgb))
    # float64 on both sides: only the order of the sums differs
    np.testing.assert_allclose(ref[0].numpy(), jref[0].numpy(), rtol=1e-9)
    np.testing.assert_allclose(ref[1].numpy(), jref[1].numpy(), rtol=1e-7,
                               atol=1e-9)
    jerr = glmm_cases.glmm_errors(out, jref)
    assert jerr["lp_rel_err"] <= 1e-5 and jerr["grad_rel_err"] <= 1e-4


# --- what the wrapper refuses -------------------------------------------------

def _fake_cuda(*shape, dtype=torch.float32, device="cuda"):
    return torch.empty(*shape, dtype=dtype, device=device)


@pytest.mark.parametrize("case, error, match", [
    ("float64", TypeError, "float32"),
    ("non_contiguous", ValueError, "contiguous"),
    ("two_cuda_devices", ValueError, "one CUDA device"),
    ("cpu_and_cuda", ValueError, "one CUDA device"),
    ("shapes", ValueError, "do not agree"),
    ("too_many_effects", ValueError, "fixed effects"),
])
def test_wrapper_refuses_without_counting_a_launch(case, error, match):
    # tensors that claim a CUDA device without a card behind them
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = tfg.glmm_loglik_grads.launches
    with FakeTensorMode():
        P = 9 if case == "too_many_effects" else 4
        Xt, y = _fake_cuda(P, 10, 8), _fake_cuda(10, 8)
        betas, bs = _fake_cuda(2, P), _fake_cuda(2, 8)
        if case == "float64":
            Xt = _fake_cuda(4, 10, 8, dtype=torch.float64)
        elif case == "non_contiguous":
            bs = torch.empty_strided((2, 8), (1, 2), device="cuda")
        elif case == "two_cuda_devices":
            bs = _fake_cuda(2, 8, device="cuda:1")
        elif case == "cpu_and_cuda":
            bs = _fake_cuda(2, 8, device="cpu")
        elif case == "shapes":
            bs = _fake_cuda(2, 9)
        with pytest.raises(error, match=match):
            tfg.glmm_loglik_grads(Xt, y, betas, bs)
    assert tfg.glmm_loglik_grads.launches == before


def test_cuda_tensors_never_take_the_plain_version(monkeypatch, tmp_path):
    # well-formed CUDA tensors go to the kernel's library; without a compiler
    # and without a library built earlier that fails, and nothing falls back
    # to the plain version
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(tfg, "glmm_loglik_grads_plain", lambda *a: pytest.fail(
        "a CUDA tensor reached the plain version"))
    monkeypatch.setattr(tfg.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(tfg, "_LIB_PATH", tmp_path / "libfused_glmm.so")
    monkeypatch.setattr(tfg, "_lib", functools.cache(tfg._lib.__wrapped__))
    before = tfg.glmm_loglik_grads.launches
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tfg.glmm_loglik_grads(_fake_cuda(4, 10, 8), _fake_cuda(10, 8),
                                  _fake_cuda(2, 4), _fake_cuda(2, 8))
    assert tfg.glmm_loglik_grads.launches == before
