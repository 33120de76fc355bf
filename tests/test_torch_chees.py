"""The port's ChEES-HMC against the JAX package's.

Parity: one ``chees_step`` over a batch of chains given the same momenta
and accept uniforms, the JAX step vmapped with ``axis_name="chains"`` (its
``lax.pmean`` is the port's mean over dim 0), in float64 at rtol 1e-10 (the
cross-chain means sum in another order).  Then the sampler's statistics,
ported from tests/test_chees.py at sizes that run in seconds on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu_torch as tmt
from mamba_tpu.samplers import chees as jchees
from mamba_tpu_torch.models import glmm as tglmm
from mamba_tpu_torch.models import line as tline
from mamba_tpu_torch.ops import fused_glmm as tfg
from mamba_tpu_torch.samplers import chees as tchees
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

RTOL = 1e-10
C, DIM = 6, 3
MEAN = np.array([0.5, -1.0, 2.0])
SD = np.array([0.4, 1.2, 0.8])


def j_logfgrad(x):
    z = (x - MEAN) / SD
    return -0.5 * jnp.sum(z * z), -z / SD


def t_logfgrad(x):
    z = (x - torch.as_tensor(MEAN)) / torch.as_tensor(SD)
    return -0.5 * torch.sum(z * z, dim=-1), -z / torch.as_tensor(SD)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _keys(seed):
    return jax.random.split(jax.random.key(seed), C)


def _draws(keys):
    """What JAX's chees_step draws from each chain's key: the momentum
    noise (before the mass scaling) and the accept uniform."""
    normals, uniforms = [], []
    for k in keys:
        kp, ka = jax.random.split(k)
        normals.append(np.asarray(jax.random.normal(kp, (DIM,), jnp.float64)))
        uniforms.append(float(jax.random.uniform(ka, (), jnp.float64)))
    return np.stack(normals), np.array(uniforms)


def _feed(monkeypatch, normals=(), uniforms=()):
    queues = {"randn": list(normals), "rand": list(uniforms)}

    def feeder(kind):
        def draw(*size, generator=None, dtype=None, device=None):
            shape = tuple(size[0]) if len(size) == 1 and not isinstance(
                size[0], int) else tuple(size)
            v = np.asarray(queues[kind].pop(0), dtype=np.float64)
            assert v.shape == shape, (kind, v.shape, shape)
            return torch.as_tensor(v, dtype=dtype or torch.float64)
        return draw

    monkeypatch.setattr(torch, "randn", feeder("randn"))
    monkeypatch.setattr(torch, "rand", feeder("rand"))
    return queues


def _jax_step(keys, xs, tunes, adapt):
    return jax.vmap(lambda k, x, t: jchees.chees_step(
        k, x, t, j_logfgrad, jnp.asarray(adapt)), axis_name="chains")(
        keys, jnp.asarray(xs), tunes)


def _jax_tunes(window=0, **shared):
    """Chain-stacked JAX tunes holding the given shared values."""
    tunes = jax.vmap(lambda k, x: jchees.chees_init(
        k, x, j_logfgrad, epsilon=0.3, max_steps=64, mass_window=window),
        axis_name="chains")(_keys(1), jnp.zeros((C, DIM)))
    return tunes._replace(**{
        k: jnp.broadcast_to(jnp.asarray(v, getattr(tunes, k).dtype),
                            getattr(tunes, k).shape) for k, v in shared.items()})


def _compare(t_tune, j_tune):
    for f in tchees.ChEESTune._fields:
        jv = np.asarray(getattr(j_tune, f))
        assert np.all(jv == jv[:1]), f"JAX field {f} not shared"
        tv = getattr(t_tune, f)
        tv = tv.numpy() if isinstance(tv, torch.Tensor) else np.asarray(tv)
        np.testing.assert_allclose(tv, jv[0], rtol=RTOL, err_msg=f)


CASES = {
    # mid-warmup: dual averaging and Adam moving, no mass window
    "adapt": (True, dict(m=3, it=5, traj=1.3, epsilon=0.35, epsilonbar=0.3,
                         Hbar=0.02, mu=np.log(3.0), adam_m=0.1, adam_v=0.05)),
    # the step that closes a mass window: minv refresh, dual averaging
    # re-centred
    "window": (True, dict(m=7, it=7, traj=0.9, w_n=3,
                          w_mean=np.array([0.4, -0.9, 1.9]),
                          w_m2=np.array([0.3, 2.0, 1.1]),
                          w_sw=np.array([0.5, 4.0, 1.5]))),
    # after warmup: epsilonbar, jitter still advancing, nothing adapts
    "frozen": (False, dict(m=40, it=123, traj=2.1, epsilonbar=0.45,
                           minv=np.array([0.2, 1.5, 0.7]))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chees_step_matches_given_the_same_draws(case, monkeypatch):
    adapt, shared = CASES[case]
    jt = _jax_tunes(window=4 if case == "window" else 0, **shared)
    xs = np.random.default_rng(2).normal(MEAN, SD, (C, DIM))
    keys = _keys(7)
    jx2, jt2 = _jax_step(keys, xs, jt, adapt)
    normals, uniforms = _draws(keys)
    tt = convert.chees_tune(jax.tree_util.tree_map(np.asarray, jt._asdict()),
                            "cpu", torch.float64)
    q = _feed(monkeypatch, [normals], [uniforms])
    tx2, tt2 = tchees.chees_step(None, _t(xs), tt, t_logfgrad, adapt)
    assert not q["randn"] and not q["rand"]
    np.testing.assert_allclose(tx2.numpy(), np.asarray(jx2), rtol=RTOL)
    accepted = ~np.all(tx2.numpy() == xs, axis=1)
    assert accepted.any()
    _compare(tt2, jt2)
    if case == "window":
        assert tt2.w_n == 0 and not np.allclose(tt2.minv.numpy(), 1.0)


def test_chees_init_matches_given_the_same_search_momenta(monkeypatch):
    keys = _keys(3)
    xs = np.random.default_rng(4).normal(0.0, 2.0, (C, DIM))
    jt = jax.vmap(lambda k, x: jchees.chees_init(k, x, j_logfgrad, mass_window=10),
                  axis_name="chains")(keys, jnp.asarray(xs))
    # JAX's per-chain step search draws its momentum from the chain's key
    r0 = np.stack([np.asarray(jax.random.normal(k, (DIM,), jnp.float64))
                   for k in keys])
    _feed(monkeypatch, [r0])
    tt = tchees.chees_init(None, _t(xs), t_logfgrad, mass_window=10)
    _compare(tt, jt)


def test_port_continues_from_a_jax_tune(monkeypatch):
    # six warmup steps in JAX, then the seventh in both given the same draws
    xs = jnp.asarray(np.random.default_rng(5).normal(MEAN, SD, (C, DIM)))
    jt = _jax_tunes(window=5)
    for i in range(6):
        xs, jt = _jax_step(_keys(100 + i), xs, jt, True)
    keys = _keys(200)
    jx2, jt2 = _jax_step(keys, xs, jt, True)
    tt = convert.chees_tune(jax.tree_util.tree_map(np.asarray, jt._asdict()),
                            "cpu", torch.float64)
    assert tt.m == 6 and tt.w_n == 1          # a window closed at step 5
    normals, uniforms = _draws(keys)
    _feed(monkeypatch, [normals], [uniforms])
    tx2, tt2 = tchees.chees_step(None, _t(np.asarray(xs)), tt, t_logfgrad, True)
    np.testing.assert_allclose(tx2.numpy(), np.asarray(jx2), rtol=RTOL)
    _compare(tt2, jt2)


def test_chees_tune_converter_refuses_unshared_fields():
    jt = _jax_tunes()
    fields = jax.tree_util.tree_map(np.asarray, jt._asdict())
    fields["traj"] = fields["traj"] + np.arange(C)
    with pytest.raises(ValueError, match="traj"):
        convert.chees_tune(fields, "cpu", torch.float64)


def test_halton2_matches():
    m = np.arange(4097)
    want = np.asarray(jax.vmap(jchees._halton2)(jnp.asarray(m, jnp.int32)))
    got = np.array([tchees._halton2(int(i)) for i in m])
    np.testing.assert_array_equal(got, want)


def test_glmm_chees_calls_the_likelihood_once_per_gradient(monkeypatch):
    # the fused GLMM's plain version on the CPU: one chain-batched call per
    # leapfrog plus one at each iteration's start
    calls = []
    inner = tfg.glmm_loglik_grads
    monkeypatch.setattr(tfg, "glmm_loglik_grads",
                        lambda *a: calls.append(a[2].shape) or inner(*a))
    steps = []
    inner_steps = tchees._steps
    monkeypatch.setattr(tchees, "_steps",
                        lambda *a: steps.append(inner_steps(*a)) or steps[-1])
    model, inputs, inits, _ = tglmm.build(G=24, n=5, seed=1, fused=True)
    model.set_samplers([tmt.ChEESHMC(model.samplers[0].params, epsilon=0.05,
                                     max_steps=16, mass_window=4)])
    sim = tmt.mcmc(model, inputs, inits, 12, burnin=6, chains=3,
                   verbose=False, device="cpu")
    assert np.isfinite(sim.value).all()
    assert len(steps) == 12 and max(steps) > 1
    assert len(calls) == sum(L + 1 for L in steps)
    assert set(calls) == {(3, 4)}             # every call batches all chains


# ---------------------------------------------------------------------------
# statistics (tests/test_chees.py at CPU-friendly sizes)
# ---------------------------------------------------------------------------

def _run(logfgrad, x0, warm, keep, seed=0, **init_kw):
    gen = torch.Generator().manual_seed(seed)
    x = x0.clone()
    tune = tchees.chees_init(gen, x, logfgrad, **init_kw)
    draws = []
    for i in range(warm + keep):
        x, tune = tchees.chees_step(gen, x, tune, logfgrad, i < warm)
        if i >= warm:
            draws.append(x)
    return torch.stack(draws).reshape(-1, x.shape[1]).numpy(), tune


def test_chees_standalone_correlated_gaussian():
    cov = torch.tensor([[1.0, 0.9], [0.9, 1.0]], dtype=torch.float64)
    prec = torch.linalg.inv(cov)

    def logfgrad(x):
        return -0.5 * torch.sum((x @ prec) * x, dim=-1), -(x @ prec)

    x0 = torch.randn(64, 2, generator=torch.Generator().manual_seed(11),
                     dtype=torch.float64)
    flat, tune = _run(logfgrad, x0, 400, 400)
    np.testing.assert_allclose(flat.mean(0), [0.0, 0.0], atol=0.06)
    np.testing.assert_allclose(np.cov(flat.T), cov.numpy(), atol=0.12)
    # the trajectory adapted beyond a single step
    assert float(tune.traj) > 1.5 * float(tune.epsilon)


def test_chees_mass_seeded_badly_scaled_gaussian():
    # N(0, diag(1e-4, 1, 1e4)): minv0 = the true variances makes every
    # coordinate unit-scale; adaptation runs throughout, as in the JAX test
    var = torch.tensor([1e-4, 1.0, 1e4], dtype=torch.float64)

    def logfgrad(x):
        return -0.5 * torch.sum(x * x / var, dim=-1), -x / var

    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(16, 3, dtype=torch.float64)
    tune = tchees.chees_init(gen, x, logfgrad, minv0=var, max_steps=64)
    draws = []
    for i in range(1200):
        x, tune = tchees.chees_step(gen, x, tune, logfgrad, True)
        if i >= 400:
            draws.append(x)
    d = torch.stack(draws).reshape(-1, 3).numpy()
    np.testing.assert_allclose(d.std(0), np.sqrt(var.numpy()), rtol=0.2)
    np.testing.assert_allclose(d.mean(0) / np.sqrt(var.numpy()), 0.0, atol=0.1)
    np.testing.assert_allclose(tune.minv.numpy(), var.numpy(), rtol=1e-6)


def test_chees_mass_window_learns_scale_heterogeneous_gaussian():
    var = torch.tensor([1e-4, 1e-2, 1e-1], dtype=torch.float64)
    mean = torch.tensor([0.3, -1.0, 2.0], dtype=torch.float64)

    def logfgrad(x):
        d = x - mean
        return -0.5 * torch.sum(d * d / var, dim=-1), -d / var

    x0 = 0.1 * torch.randn(64, 3, generator=torch.Generator().manual_seed(42),
                           dtype=torch.float64)
    flat, tune = _run(logfgrad, x0, 600, 600, seed=7, max_steps=128,
                      mass_window=100)
    ratio = tune.minv.numpy() / var.numpy()
    assert (ratio > 0.4).all() and (ratio < 2.5).all(), ratio
    z_err = (flat.mean(0) - mean.numpy()) / np.sqrt(var.numpy())
    assert np.abs(z_err).max() < 0.15, z_err
    np.testing.assert_allclose(flat.std(0), np.sqrt(var.numpy()), rtol=0.2)


def test_chees_in_engine_line_model():
    model, inputs, inits = tline.build(chains=8)
    model.set_samplers([tmt.ChEESHMC("beta"), tmt.Slice("s2", 2.0)])
    init = dict(inits[0], beta=np.zeros(2), s2=1.0)
    # the correlated (beta[1], beta[2]) posterior takes ~30 leapfrogs an
    # iteration: a short run keeps this test at seconds
    sim = tmt.mcmc(model, inputs, [init], 450, burnin=200, chains=8,
                   verbose=False, device="cpu", seed=3)
    names = list(sim.names)
    b1 = sim.value[:, names.index("beta[1]"), :].mean()
    b2 = sim.value[:, names.index("beta[2]"), :].mean()
    assert abs(b1 - 0.6) < 0.45, b1
    assert abs(b2 - 0.8) < 0.15, b2
    assert np.all(sim.value[:, names.index("s2"), :] > 0)
    tune = sim.states["tunes"][0]
    assert tune.m == 200 and tune.it == 450


@pytest.mark.slow
def test_chees_ess_scales_with_chains():
    # the JAX package's regression for the per-draw efficiency collapse
    # with over-dispersed inits: from one shared init (the sampler's
    # initialization contract), per-draw efficiency must not collapse as
    # the chain count grows
    from mamba_tpu_torch.models import rats as trats
    eff = {}
    for chains in (8, 64):
        model, inputs, inits = trats.build("nuts")
        model.set_samplers([tmt.ChEESHMC(model.samplers[0].params,
                                         mass_window=50), *model.samplers[1:]])
        sim = tmt.mcmc(model, inputs, [inits[0]], 500, burnin=150,
                       chains=chains, verbose=False, device="cpu", seed=11)
        kept = sim.value.shape[0]
        eff[chains] = float(np.sum(tmt.ess_bulk(sim.value))) / (chains * kept)
        assert float(np.max(tmt.rhat_rank(sim.value))) < 1.05, (chains, eff)
    assert eff[64] > 0.5 * eff[8], eff
