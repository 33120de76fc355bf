"""The port's chain-batched binary samplers (BHMC, BIA, BMC3, BMG) and ABC
against the JAX package's.

Each binary kernel takes one step per chain in JAX under
``jax.disable_jit()`` while its draws are recorded, and the same numbers go
to the port's batched step in the port's order (the module docstring of
``samplers/binary.py`` lists it); rtol 1e-12 in float64.  The port picks k
coordinates as the ``argsort`` of uniforms, so a recorded permutation
``perm`` replays as ``u[perm[j]] = (j + 0.5) / n``, and a group as
``(g + 0.5) / G``.  Then, as the JAX package's tests do, each kernel is held
in distribution to a 3-bit target with known marginals, and ABC to a
conjugate normal posterior."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.samplers import binary as jbin
from mamba_tpu_torch.samplers import binary as tbin
from mamba_tpu_torch.samplers.base import candidate_logf
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

RTOL = 1e-12
C = 4
P1 = np.array([0.8, 0.5, 0.2])


def j_logf(x):
    return jnp.sum(x * jnp.log(P1) + (1 - x) * jnp.log(1 - P1))


def t_logf(x):
    p = torch.as_tensor(P1)
    return torch.sum(x * torch.log(p) + (1 - x) * torch.log(1 - p), -1)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@contextlib.contextmanager
def fed(monkeypatch, rand=(), randn=()):
    """The port's ``torch.rand`` / ``torch.randn`` return the given arrays
    in order, each checked against the shape asked for."""
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
    events = []

    def wrap(kind, inner):
        def draw(*a, **k):
            v = inner(*a, **k)
            events.append((kind, np.asarray(v)))
            return v
        return draw

    with monkeypatch.context() as m:
        for kind in ("uniform", "normal", "permutation", "randint"):
            m.setattr(jax.random, kind, wrap(kind, getattr(jax.random, kind)))
        with jax.disable_jit():
            out = fn()
    return out, events


def _x0(seed=0):
    return np.random.default_rng(seed).integers(0, 2, (C, 3)).astype(float)


def _per_chain(monkeypatch, step, x0, tunes, seed):
    outs, events = [], []
    for c in range(C):
        out, ev = _recorded(monkeypatch, lambda: step(
            jax.random.key(seed + c), jnp.asarray(x0[c]), tunes[c]))
        outs.append(out)
        events.append(ev)
    return outs, events


def _index_feed(ev, n=3, G=None):
    """The recorded index draw of one chain as the port's uniforms."""
    kind, v = ev
    if kind == "permutation":
        u = np.empty(n)
        u[v] = (np.arange(n) + 0.5) / n
        return u
    assert kind == "randint"
    return (float(v) + 0.5) / G


def test_bhmc_step_matches_given_the_same_draws(monkeypatch):
    x0 = _x0(1)
    jt = [jbin.bhmc_init(jax.random.key(9), jnp.zeros(3), 2.5 * np.pi)._replace(
        wallhits=jnp.asarray(c, jnp.int32)) for c in range(C)]
    outs, events = _per_chain(monkeypatch, lambda k, x, t: jbin.bhmc_step(
        k, x, t, j_logf), x0, jt, 10)
    normals = [[v for k, v in ev if k == "normal"] for ev in events]
    stacked = {f: np.stack([np.asarray(getattr(t, f)) for t in jt])
               for f in jbin.BHMCTune._fields}
    tt = convert.bhmc_tune(stacked, "cpu", torch.float64)
    with fed(monkeypatch, randn=[np.stack([n[0] for n in normals]),
                                 np.stack([n[1] for n in normals])]):
        x2, t2 = tbin.bhmc_step(None, _t(x0), tt, t_logf)
    np.testing.assert_array_equal(x2.numpy(), np.stack([np.asarray(o[0]) for o in outs]))
    for f in ("position", "velocity"):
        np.testing.assert_allclose(getattr(t2, f).numpy(),
                                   np.stack([np.asarray(getattr(o[1], f)) for o in outs]),
                                   rtol=RTOL, atol=1e-13, err_msg=f)
    for f in ("wallhits", "wallcrosses"):
        np.testing.assert_array_equal(getattr(t2, f).numpy(),
                                      [int(getattr(o[1], f)) for o in outs], err_msg=f)
    assert (t2.wallhits.numpy() > np.arange(C)).all()        # the counters advance


def test_bia_step_matches_given_the_same_draws(monkeypatch):
    x0 = _x0(2)
    rng = np.random.default_rng(3)
    jt = [jbin.bia_init(jnp.zeros(3), A=rng.uniform(0.1, 0.9, 3),
                        D=rng.uniform(0.1, 0.9, 3))._replace(
        iter=jnp.asarray(7, jnp.int32)) for _ in range(C)]
    outs, events = _per_chain(monkeypatch, lambda k, x, t: jbin.bia_step(
        k, x, t, j_logf), x0, jt, 20)
    us = [[v for k, v in ev if k == "uniform"] for ev in events]
    stacked = {f: np.stack([np.asarray(getattr(t, f)) for t in jt])
               for f in jbin.BIATune._fields}
    tt = convert.bia_tune(stacked, "cpu", torch.float64)
    with fed(monkeypatch, rand=[np.stack([u[0] for u in us]),
                                np.array([u[1] for u in us])]):
        x2, t2 = tbin.bia_step(None, _t(x0), tt, t_logf)
    np.testing.assert_array_equal(x2.numpy(), np.stack([np.asarray(o[0]) for o in outs]))
    for f in ("A", "D"):
        np.testing.assert_allclose(getattr(t2, f).numpy(),
                                   np.stack([np.asarray(getattr(o[1], f)) for o in outs]),
                                   rtol=RTOL, err_msg=f)
    assert t2.iter == 8


@pytest.mark.parametrize("kernel,k", [("bmc3", 1), ("bmc3", 2),
                                      ("bmc3", [[0], [1, 2], [0, 1, 2]]),
                                      ("bmg", 1), ("bmg", 2), ("bmg", [[0, 2], [1]])])
def test_index_kernels_match_given_the_same_draws(kernel, k, monkeypatch):
    jinit, jstep = {"bmc3": (jbin.bmc3_init, jbin.bmc3_step),
                    "bmg": (jbin.bmg_init, jbin.bmg_step)}[kernel]
    tstep = {"bmc3": tbin.bmc3_step, "bmg": tbin.bmg_step}[kernel]
    x0 = _x0(4)
    jt = jinit(jnp.zeros(3), k)
    outs, events = _per_chain(monkeypatch, lambda key, x, t: jstep(
        key, x, t, j_logf), x0, [jt] * C, 30)
    G = None if isinstance(k, int) else len(k)
    idx = [_index_feed(ev[0], G=G) for ev in events]
    us = [[v for kind, v in ev if kind == "uniform"] for ev in events]
    feed = [np.stack(idx) if G is None else np.array(idx)]
    if kernel == "bmg":
        feed.append(np.stack([u[0] for u in us]))            # the proposals
    feed.append(np.array([u[-1] for u in us]))                # the acceptance
    tt = convert.index_tune(jt, "cpu", torch.float64)
    assert tt.k == (k if G is None else 0)
    with fed(monkeypatch, rand=feed):
        x2, _ = tstep(None, _t(x0), tt, t_logf)
    np.testing.assert_array_equal(x2.numpy(), np.stack([np.asarray(o[0]) for o in outs]))


# ---- in distribution: the 3-bit target of the JAX package's tests ---------

def _run(step, tune, n=150, chains=64, seed=0, burn=30):
    gen = torch.Generator().manual_seed(seed)
    x = torch.zeros(chains, 3, dtype=torch.float64)
    draws = []
    for i in range(n):
        x, tune = step(gen, x, tune)
        if i >= burn:
            draws.append(x.numpy())
    d = np.concatenate(draws)
    assert set(np.unique(d)) <= {0.0, 1.0}
    return d, tune


def _x(chains=64):
    return torch.zeros(chains, 3, dtype=torch.float64)


@pytest.mark.parametrize("name", ["bmc3", "bmc3_groups", "bmg", "bmg_k2", "bia",
                                  "bhmc"])
def test_binary_kernels_reach_the_marginals(name):
    step, tune = {
        "bmc3": (tbin.bmc3_step, tbin.bmc3_init(_x(), 1)),
        "bmc3_groups": (tbin.bmc3_step, tbin.bmc3_init(_x(), [[0], [1], [2], [0, 1, 2]])),
        "bmg": (tbin.bmg_step, tbin.bmg_init(_x(), 1)),
        "bmg_k2": (tbin.bmg_step, tbin.bmg_init(_x(), 2)),
        "bia": (tbin.bia_step, tbin.bia_init(_x())),
        "bhmc": (tbin.bhmc_step, tbin.bhmc_init(torch.Generator().manual_seed(42),
                                                _x(), 1.5 * np.pi)),
    }[name]
    d, tune = _run(lambda g, x, t: step(g, x, t, t_logf), tune,
                   n=250 if name == "bia" else 150)
    np.testing.assert_allclose(d.mean(0), P1, atol=0.04)
    if name == "bia":
        assert tune.iter == 250 and not torch.equal(tune.A, torch.full_like(tune.A, 1 / 3))
    if name == "bhmc":
        assert (tune.wallhits > 0).all() and (tune.wallcrosses > 0).all()


def test_index_kernels_validate():
    with pytest.raises(ValueError, match="exceeds"):
        tbin.bmc3_init(_x(), 5)
    with pytest.raises(ValueError, match="exceeds"):
        tbin.bmg_init(_x(), [[0, 3]])
    with pytest.raises(ValueError, match="binary"):
        tbin.bmc3_init(_x() + 0.5, 1)
    with pytest.raises(ValueError, match="epsilon"):
        tbin.bia_init(_x(), epsilon=0.7)


def test_bhmc_walls_hit_at_the_same_instant(monkeypatch):
    # both coordinates start on their walls, moving (position 0, velocity
    # 1): they are hit at the same instant.  The JAX package guards the last
    # wall only, so the two take turns at move time 0 until max_hits; the
    # port guards every wall hit that recently and moves on
    def lf(x):
        return jnp.sum(x * jnp.log(P1[:2]) + (1 - x) * jnp.log(1 - P1[:2]))

    draws = iter([jnp.zeros(2), jnp.zeros(2), jnp.zeros(2), jnp.ones(2)])
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", lambda *a, **k: next(draws))
        with jax.disable_jit():
            jt = jbin.bhmc_init(jax.random.key(0), jnp.zeros(2), 2.0)
            _, jt2 = jbin.bhmc_step(jax.random.key(1), jnp.ones(2), jt, lf,
                                    max_hits=60)
    assert int(jt2.wallhits) == 60                      # ran into max_hits

    def tlf(x):
        p = torch.as_tensor(P1[:2])
        return torch.sum(x * torch.log(p) + (1 - x) * torch.log(1 - p), -1)

    x = torch.ones(C, 2, dtype=torch.float64)
    for dtype in (torch.float64, torch.float32):
        tt = tbin.bhmc_init(torch.Generator().manual_seed(0), x.to(dtype), 2.0)
        with fed(monkeypatch, randn=[np.zeros((C, 2)), np.ones((C, 2))]):
            x2, t2 = tbin.bhmc_step(None, x.to(dtype), tt, tlf, max_hits=60)
        assert (t2.wallhits <= 3).all() and torch.isfinite(t2.velocity).all()


def test_bhmc_float32_trajectories_stay_below_max_hits():
    # pollution's own block density in float32, at its traveltime
    # (2P + 0.5) pi: the wall guard scales with the dtype, so no trajectory
    # finds the wall it just left again and runs into max_hits
    from mamba_tpu_torch.models import pollution
    model, inputs, inits = pollution.build("bhmc")
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu",
                           dtype=torch.float32)
    from mamba_tpu_torch.model.mcmc import _chain_inits
    state = _chain_inits(cm, inits, 8)
    block = model.samplers[0]
    kern = block.build(cm)
    gen = torch.Generator().manual_seed(0)
    tune = kern.init(gen, state)
    max_hits = 2000
    _, _, _, logf = cm.block_functions(("gamma",), False)
    f = candidate_logf(torch.func.vmap(logf), state)
    x = state["gamma"]
    for _ in range(3):
        before = tune.wallhits.clone()
        x, tune = tbin.bhmc_step(gen, x, tune, f, max_hits=max_hits)
        hits = (tune.wallhits - before).numpy()
        assert x.dtype == torch.float32 and set(np.unique(x.numpy())) <= {0.0, 1.0}
        assert (hits > 100).all() and (hits < max_hits // 2).all(), hits


# ---------------------------------------------------------------------------
# ABC
# ---------------------------------------------------------------------------

def test_abc_conjugate_normal():
    # y ~ N(mu, 1), mu ~ N(0, 10): with the mean as summary and a tight
    # tolerance, ABC approximates the exact conjugate posterior
    y = np.array([0.8, 1.2, 1.1, 0.9, 1.3, 0.7, 1.0, 1.05])
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu: tmt.Normal(mu.expand(len(y)), 1.0),
                         monitor=False),
        mu=tmt.Stochastic(lambda: tmt.Normal(0.0, np.sqrt(10.0))),
    )
    model.set_samplers([tmt.ABC("mu", scale=0.5, summary=lambda x: torch.mean(x),
                                epsilon=0.25, maxdraw=10, nsim=3)])
    sim = tmt.mcmc(model, {}, [{"y": y, "mu": 0.0}], 200, burnin=80, chains=48,
                   verbose=False, device="cpu")
    s = tmt.summarystats(sim).to_dict()
    post_mean = y.sum() / (len(y) + 1 / 10.0)
    assert abs(s["mu"]["Mean"] - post_mean) < 0.1
    assert 0.2 < s["mu"]["SD"] < 0.6
    v = sim.value[:, 0, :]
    assert (np.diff(v, axis=0) != 0).mean() > 0.05         # the chains move
    t = sim.states["tunes"][0]
    assert tuple(t.Tsim.shape) == (48, 3, 1) and tuple(t.epsilon.shape) == (48, 3)


def test_abc_requires_data_targets():
    model = tmt.Model(mu=tmt.Stochastic(lambda: tmt.Normal(0.0, 1.0)))
    model.set_samplers([tmt.ABC("mu", 1.0, lambda x: x, 0.1)])
    cm = tmt.compile_model(model, {}, {"mu": 0.0}, device="cpu")
    with pytest.raises(ValueError, match="data targets"):
        model.samplers[0].build(cm)


@pytest.mark.parametrize("name", ["line_abc", "gk"])
def test_prior_only_block_functions_match(name):
    import importlib
    tmod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    jmod = importlib.import_module(f"mamba_tpu.models.{name}")
    tm, tin, tinits = tmod.build()
    jm, jin, jinits = jmod.build()
    tcm = tmt.compile_model(tm, tin, tinits[0], device="cpu")
    jcm = jmt.compile_model(jm, jin, jinits[0])
    rng = np.random.default_rng(6)
    for spec in tm.samplers:
        tpack, _, _, tlogf = tcm.block_functions(spec.params, True, prior_only=True)
        jpack, _, _, jlogf = jcm.block_functions(spec.params, True, prior_only=True)
        for init in tinits:
            st = {k: np.asarray(v, dtype=float) for k, v in init.items()}
            x = tpack(convert.to_tensors(st, "cpu", torch.float64))
            jx = jpack({k: jnp.asarray(v) for k, v in st.items()})
            np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12)
            u = rng.normal(0.0, 0.3, x.shape)
            tv = tlogf(x + _t(u), convert.to_tensors(st, "cpu", torch.float64))
            jv = jlogf(jx + u, {k: jnp.asarray(v) for k, v in st.items()})
            np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-10)
        # prior only: the data node's density is not in it
        _, _, _, full = tcm.block_functions(spec.params, True)
        assert full is not tlogf


def test_gk_summary_is_jnp_quantile():
    # gk's order statistics by torch.sort and linear interpolation (they
    # batch over chains; torch.quantile does not) against jnp.quantile's
    # default method, one sample and chain-stacked under vmap
    from mamba_tpu.models import gk as jgk
    from mamba_tpu_torch.models import gk as tgk
    x = np.random.default_rng(8).standard_normal((4, tgk.NOBS)) ** 3
    want = np.stack([np.asarray(jgk._stats(jnp.asarray(row))) for row in x])
    np.testing.assert_allclose(tgk._stats(_t(x[0])).numpy(), want[0], rtol=1e-12)
    got = torch.func.vmap(tgk._stats)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
