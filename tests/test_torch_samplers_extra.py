"""The port's chain-batched Slice, AMWG, RWM, HMC and MALA against the JAX
package's, one step at a time given the same random numbers.

The two packages draw different streams (threefry vs Philox), so the JAX
step runs once per chain with its own key while its draws are recorded, and
the same numbers are handed to the port's batched step in the order the
port draws them (each module's docstring lists that order).  Tolerance:
rtol 1e-12 in float64 — the same arithmetic in the same order, up to
summation order in the block density."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.samplers import amwg as jamwg
from mamba_tpu.samplers import hmc as jhmc
from mamba_tpu.samplers import mala as jmala
from mamba_tpu.samplers import rwm as jrwm
from mamba_tpu.samplers import slice as jslice
from mamba_tpu_torch.models import line as tline
from mamba_tpu_torch.samplers import amwg as tamwg
from mamba_tpu_torch.samplers import hmc as thmc
from mamba_tpu_torch.samplers import mala as tmala
from mamba_tpu_torch.samplers import rwm as trwm
from mamba_tpu_torch.samplers import slice as tslice
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

RTOL = 1e-12
MEAN = np.array([1.0, -2.0, 0.5])
SD = np.array([0.3, 1.5, 0.8])
C, DIM = 5, 3


def j_logf(x):
    return -0.5 * jnp.sum(((x - MEAN) / SD) ** 2)


def j_logfgrad(x):
    return j_logf(x), jax.grad(j_logf)(x)


def t_logf(x):
    z = (x - torch.as_tensor(MEAN)) / torch.as_tensor(SD)
    return -0.5 * torch.sum(z * z, dim=-1)


def t_logfgrad(x):
    z = (x - torch.as_tensor(MEAN)) / torch.as_tensor(SD)
    return -0.5 * torch.sum(z * z, dim=-1), -z / torch.as_tensor(SD)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _x0(seed=0):
    return np.random.default_rng(seed).normal(0.0, 1.0, (C, DIM))


def _keys(seed):
    return [jax.random.key(seed + c) for c in range(C)]


@contextlib.contextmanager
def fed(monkeypatch, rand=(), randn=()):
    """The port's ``torch.rand`` / ``torch.randn`` return the given arrays in
    order, each checked against the shape asked for; every array must be
    used."""
    queues = {"rand": list(rand), "randn": list(randn)}

    def feeder(kind):
        def draw(*size, generator=None, dtype=None, device=None):
            shape = tuple(size[0]) if len(size) == 1 and not isinstance(
                size[0], int) else tuple(size)
            assert queues[kind], f"unexpected torch.{kind}{shape}"
            v = np.asarray(queues[kind].pop(0), dtype=np.float64)
            assert v.shape == shape, (kind, v.shape, shape)
            return torch.as_tensor(v, dtype=dtype or torch.float64)
        return draw

    with monkeypatch.context() as m:
        m.setattr(torch, "rand", feeder("rand"))
        m.setattr(torch, "randn", feeder("randn"))
        yield
    assert not queues["rand"] and not queues["randn"], "draws left unused"


def _recorded(monkeypatch, fn):
    """Run ``fn()`` with JAX's jit disabled (so its loops run in Python) and
    every ``jax.random`` uniform, normal and split recorded in order."""
    events = []
    ou, on, osp = jax.random.uniform, jax.random.normal, jax.random.split

    def u(key, shape=(), dtype=None, *a, **k):
        v = ou(key, shape, dtype, *a, **k)
        events.append(("u", np.asarray(v)))
        return v

    def n(key, shape=(), dtype=None):
        v = on(key, shape, dtype)
        events.append(("n", np.asarray(v)))
        return v

    def s(key, num=2):
        events.append(("s", num))
        return osp(key, num)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform", u)
        m.setattr(jax.random, "normal", n)
        m.setattr(jax.random, "split", s)
        with jax.disable_jit():
            out = fn()
    return out, events


def _draws(events, kind):
    return [v for k, v in events if k == kind]


# ---------------------------------------------------------------------------
# Slice
# ---------------------------------------------------------------------------

def _univariate_feed(per_chain_events):
    """JAX's univariate draws per chain -> the port's batched draw order:
    offsets (C, dim); per coordinate: level (C,), candidate (C,), then one
    (C,) per lockstep shrink trip (chains already accepted get filler)."""
    coords = []
    for ev in per_chain_events:
        lower = None
        cs = []
        it = iter(ev)
        for e in it:
            if e == ("s", 3):
                cs.append({"p0": next(it)[1], "x": [next(it)[1]]})
            elif e[0] == "u" and lower is None:
                lower = e[1]
            elif e[0] == "u":
                cs[-1]["x"].append(e[1])
        coords.append((lower, cs))
    feed = [np.stack([lo for lo, _ in coords])]
    for i in range(DIM):
        per = [cs[i] for _, cs in coords]
        feed.append(np.array([p["p0"] for p in per]))
        trips = max(len(p["x"]) for p in per)
        for k in range(trips):
            feed.append(np.array([p["x"][k] if k < len(p["x"]) else 0.5
                                  for p in per]))
    return feed


def _multivariate_feed(per_chain_events):
    """JAX's multivariate draws per chain -> the port's order: level (C,),
    offsets, candidate, then one (C, dim) per lockstep shrink trip."""
    us = [_draws(ev, "u") for ev in per_chain_events]
    trips = max(len(u) for u in us) - 3
    feed = [np.array([u[0] for u in us]), np.stack([u[1] for u in us]),
            np.stack([u[2] for u in us])]
    for k in range(trips):
        feed.append(np.stack([u[3 + k] if 3 + k < len(u) else np.full(DIM, 0.5)
                              for u in us]))
    return feed


@pytest.mark.parametrize("form", ["univariate", "multivariate"])
def test_slice_step_matches_given_the_same_uniforms(form, monkeypatch):
    x0 = _x0(1)
    # wide brackets: most candidates are rejected and the bracket shrinks
    width = np.array([4.0, 6.0, 5.0]) * (1.0 if form == "univariate" else 4.0)
    jstep = {"univariate": jslice.slice_univariate_step,
             "multivariate": jslice.slice_multivariate_step}[form]
    jtune = jslice.slice_init(jnp.zeros(DIM), jnp.asarray(width))
    j_out, events = [], []
    for c, key in enumerate(_keys(20)):
        (x2, _), ev = _recorded(monkeypatch, lambda: jstep(
            key, jnp.asarray(x0[c]), jtune, j_logf))
        j_out.append(np.asarray(x2))
        events.append(ev)
    trips = [sum(e == ("s", 2) for e in ev) for ev in events]
    assert max(trips) > 3, trips           # the shrink loop ran
    feed = (_univariate_feed if form == "univariate" else _multivariate_feed)(events)
    ttune = convert.slice_tune(
        {"width": np.broadcast_to(np.asarray(jtune.width), (C, DIM))},
        "cpu", torch.float64)
    tstep = {"univariate": tslice.slice_univariate_step,
             "multivariate": tslice.slice_multivariate_step}[form]
    with fed(monkeypatch, rand=feed):
        x2, _ = tstep(None, _t(x0), ttune, t_logf)
    np.testing.assert_allclose(x2.numpy(), np.stack(j_out), rtol=RTOL)


@pytest.mark.parametrize("form", ["univariate", "multivariate"])
def test_slice_cap_rejects_and_restores_the_entry_density(form):
    # a degenerate density: the entry state's value (0) cannot be reached
    # again, every later evaluation is -inf, so no candidate ever reaches
    # the slice level and every chain hits MAX_SHRINK
    calls = []

    def logf(x):
        calls.append(x.clone())
        lp = torch.zeros(x.shape[0], dtype=x.dtype)
        return lp if len(calls) == 1 else lp - torch.inf

    gen = torch.Generator().manual_seed(0)
    x = _t(_x0(2))[:, :1] if form == "univariate" else _t(_x0(2))
    tune = tslice.slice_init(x, 2.0)
    step = (tslice.slice_univariate_step if form == "univariate"
            else tslice.slice_multivariate_step)
    x2, _ = step(gen, x, tune, logf)
    torch.testing.assert_close(x2, x, rtol=0, atol=0)     # the move is rejected
    # the entry evaluation, the first candidate and one per shrink trip; no
    # evaluation to restore the entry value
    assert len(calls) == 2 + tslice.MAX_SHRINK


def test_slice_block_density_is_minus_inf_outside_support():
    # transform=False: the slice works on the raw variance, where s2 < 0
    # makes the likelihood's sqrt NaN; the block density must be -inf
    model, inputs, inits = tline.build(chains=2)
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
    pack, _, _, logf = cm.block_functions(("s2",), False)
    state = convert.to_tensors(
        {k: np.stack([np.asarray(i[k], float) for i in inits]) for k in inits[0]},
        "cpu", torch.float64)
    flat = torch.func.vmap(pack)(state)
    lp = torch.func.vmap(logf)(torch.stack([-flat[0], flat[1]]), state)
    assert torch.isneginf(lp[0]) and torch.isfinite(lp[1])
    jcm = jmt.compile_model(jmt.models.line.build(chains=2)[0], inputs, inits[0])
    _, _, _, jlogf = jcm.block_functions(("s2",), False)
    jstate = {k: jnp.asarray(state[k][1].numpy()) for k in state}
    np.testing.assert_allclose(lp[1].item(), float(jlogf(jnp.asarray(flat[1].numpy()),
                                                         jstate)), rtol=RTOL)


# ---------------------------------------------------------------------------
# AMWG
# ---------------------------------------------------------------------------

def _jax_amwg_tunes(m):
    rng = np.random.default_rng(5)
    return [jamwg.amwg_init(jnp.zeros(DIM), jnp.asarray(rng.uniform(0.2, 2.0, DIM)),
                            batchsize=10)._replace(
        accept=jnp.asarray(rng.integers(0, m + 1, DIM), jnp.int32),
        m=jnp.asarray(m, jnp.int32)) for _ in range(C)]


@pytest.mark.parametrize("adapt, m", [(True, 9), (True, 4), (False, 9)])
def test_amwg_step_matches_given_the_same_draws(adapt, m, monkeypatch):
    # m = 9 with batchsize 10: this step closes an adaptation batch
    x0 = _x0(3)
    jtunes = _jax_amwg_tunes(m)
    j_x, j_t, normals, uniforms = [], [], [], []
    for c, key in enumerate(_keys(40)):
        (x2, t2), ev = _recorded(monkeypatch, lambda: jamwg.amwg_step(
            key, jnp.asarray(x0[c]), jtunes[c], j_logf, jnp.asarray(adapt)))
        j_x.append(np.asarray(x2))
        j_t.append(t2)
        normals.append(_draws(ev, "n")[0])
        uniforms.append(_draws(ev, "u")[0])
    stacked = {f: np.stack([np.asarray(getattr(t, f)) for t in jtunes])
               for f in ("sigma", "accept", "m", "batchsize", "target")}
    ttune = convert.amwg_tune(stacked, "cpu", torch.float64)
    with fed(monkeypatch, rand=[np.stack(uniforms)], randn=[np.stack(normals)]):
        x2, t2 = tamwg.amwg_step(None, _t(x0), ttune, t_logf, adapt)
    np.testing.assert_allclose(x2.numpy(), np.stack(j_x), rtol=RTOL)
    np.testing.assert_allclose(t2.sigma.numpy(),
                               np.stack([np.asarray(t.sigma) for t in j_t]), rtol=RTOL)
    np.testing.assert_array_equal(t2.accept.numpy(),
                                  np.stack([np.asarray(t.accept) for t in j_t]))
    assert t2.m == int(j_t[0].m)


def test_amwg_adapt_modes():
    spec = tmt.AMWG("beta", 1.0, adapt="burnin")
    gen = torch.Generator().manual_seed(1)
    tune = spec.kernel_init(gen, _t(_x0()), t_logf)
    _, t1 = spec.kernel_step(gen, _t(_x0()), tune, t_logf, False)
    assert t1.m == 0
    _, t1 = spec.kernel_step(gen, _t(_x0()), tune, t_logf, True)
    assert t1.m == 1
    _, t1 = tmt.AMWG("beta", 1.0, adapt="none").kernel_step(
        gen, _t(_x0()), tune, t_logf, True)
    assert t1.m == 0
    with pytest.raises(ValueError):
        tmt.AMWG("beta", 1.0, adapt="sometimes")


# ---------------------------------------------------------------------------
# RWM, HMC, MALA
# ---------------------------------------------------------------------------

def _sigma():
    """A proposal covariance on the target's scales, mildly correlated."""
    R = np.array([[1.0, 0.3, -0.2], [0.3, 1.0, 0.1], [-0.2, 0.1, 1.0]])
    return SD[:, None] * R * SD[None, :]


def _compare_mh(monkeypatch, jfn, tfn, seed):
    """One MH-type step per chain in JAX (recording its normal and uniform
    draws) and once batched in the port fed the same numbers."""
    x0 = _x0(seed)
    j_x, normals, uniforms = [], [], []
    for c, key in enumerate(_keys(seed * 10)):
        (x2, _), ev = _recorded(monkeypatch, lambda: jfn(key, jnp.asarray(x0[c])))
        j_x.append(np.asarray(x2))
        normals.append(_draws(ev, "n")[0])
        uniforms.append(_draws(ev, "u")[0])
    with fed(monkeypatch, rand=[np.array(uniforms)], randn=[np.stack(normals)]):
        x2, _ = tfn(_t(x0))
    np.testing.assert_allclose(x2.numpy(), np.stack(j_x), rtol=RTOL)
    moved = ~np.all(x2.numpy() == x0, axis=1)
    return moved


def test_rwm_step_matches(monkeypatch):
    scale = np.array([0.5, 2.0, 1.0])
    jt = jrwm.rwm_init(jnp.zeros(DIM), jnp.asarray(scale))
    tt = trwm.rwm_init(_t(_x0()), scale)
    moved = _compare_mh(monkeypatch, lambda k, x: jrwm.rwm_step(k, x, jt, j_logf),
                        lambda x: trwm.rwm_step(None, x, tt, t_logf), 7)
    assert moved.any() and not moved.all()


@pytest.mark.parametrize("with_sigma", [False, True])
def test_hmc_step_matches(with_sigma, monkeypatch):
    Sigma = _sigma() if with_sigma else None
    jt = jhmc.hmc_init(jnp.zeros(DIM), 0.25, 6, None if Sigma is None else jnp.asarray(Sigma))
    tt = thmc.hmc_init(_t(_x0()), 0.25, 6, Sigma)
    if with_sigma:
        np.testing.assert_allclose(tt.SigmaL.numpy(), np.asarray(jt.SigmaL), rtol=RTOL)
    moved = _compare_mh(monkeypatch, lambda k, x: jhmc.hmc_step(k, x, jt, j_logfgrad),
                        lambda x: thmc.hmc_step(None, x, tt, t_logfgrad), 8)
    assert moved.any()


@pytest.mark.parametrize("with_sigma", [False, True])
def test_mala_step_matches(with_sigma, monkeypatch):
    Sigma = _sigma() if with_sigma else None
    jt = jmala.mala_init(jnp.zeros(DIM), 0.15, None if Sigma is None else jnp.asarray(Sigma))
    tt = tmala.mala_init(_t(_x0()), 0.15, Sigma)
    moved = _compare_mh(monkeypatch, lambda k, x: jmala.mala_step(k, x, jt, j_logfgrad),
                        lambda x: tmala.mala_step(None, x, tt, t_logfgrad), 9)
    assert moved.any()


# ---------------------------------------------------------------------------
# the samplers in the engine, statistically
# ---------------------------------------------------------------------------

def _line_posterior(scheme_blocks, iters=1200, burnin=400, chains=4, seed=3):
    model, inputs, inits = tline.build(chains=chains)
    model.set_samplers(scheme_blocks)
    sim = tmt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=chains,
                   verbose=False, device="cpu", seed=seed)
    assert np.isfinite(sim.value).all()
    assert (sim.value[:, sim.names.index("s2"), :] > 0).all()
    return tmt.summarystats(sim).to_dict()


@pytest.mark.parametrize("name", ["amwg_slice", "rwm_slice_uni", "hmc_slice",
                                  "mala_slice"])
def test_samplers_in_engine_reach_line_posterior(name):
    # golden means (reference doc/tutorial.rst:432-442): beta[2] 0.8017 with
    # posterior SD 0.35; a few hundred kept draws per chain put the mean
    # within ~0.15
    blocks = {
        "amwg_slice": [tmt.AMWG("beta", np.ones(2)), tmt.Slice("s2", 3.0)],
        "rwm_slice_uni": [tmt.RWM("beta", np.array([1.0, 0.3])),
                          tmt.Slice("s2", 3.0, form="univariate")],
        "hmc_slice": [tmt.HMC("beta", 0.2, 4), tmt.Slice("s2", 1.0, transform=True)],
        "mala_slice": [tmt.MALA("beta", 0.05), tmt.Slice("s2", 3.0)],
    }[name]
    s = _line_posterior(blocks)
    assert abs(s["beta[2]"]["Mean"] - 0.8017) < 0.2, s["beta[2]"]
