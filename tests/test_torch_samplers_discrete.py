"""The port's chain-batched SliceSimplex and DGS against the JAX package's,
one step at a time given the same random numbers, and in distribution
against exact targets.

The JAX step runs once per chain under ``jax.disable_jit()`` (its
``while_loop``s then run in Python) while its draws are recorded, and the
same numbers go to the port's batched step in the order the port draws them
(each module's docstring lists it).  The port draws a Dirichlet(1, ..., 1)
point as normalized exponentials ``-log(1 - u)``, so a recorded point ``w``
replays as ``u = 1 - exp(-w)``; it draws Gumbel noise as ``-log(-log u)``,
so a recorded ``g`` replays as ``u = exp(-exp(-g))``.  Tolerance: rtol 1e-12
in float64."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_feed import fed
import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu_torch.ops import random as R
from mamba_tpu.samplers import dgs as jdgs
from mamba_tpu.samplers import slicesimplex as jss
from mamba_tpu_torch.samplers import dgs as tdgs
from mamba_tpu_torch.samplers import slicesimplex as tss
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

RTOL = 1e-12
C = 4
#: the port's per-chain keys where a test feeds the draws
KEYS = R.chain_keys(0, range(C))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _recorded(monkeypatch, fn, kinds=("uniform", "dirichlet", "gumbel")):
    """Run ``fn()`` with JAX's jit disabled and every ``jax.random`` draw of
    the given kinds recorded in order as ``(kind, value)``."""
    events = []

    def wrap(kind, inner):
        def draw(*a, **k):
            v = inner(*a, **k)
            events.append((kind, np.asarray(v)))
            return v
        return draw

    with monkeypatch.context() as m:
        for kind in kinds:
            m.setattr(jax.random, kind, wrap(kind, getattr(jax.random, kind)))
        with jax.disable_jit():
            out = fn()
    return out, events


# ---------------------------------------------------------------------------
# SliceSimplex
# ---------------------------------------------------------------------------

ALPHA = np.array([3.0, 1.0, 1.0, 2.0])


def j_dirichlet_logf(x):
    return jnp.sum((ALPHA - 1) * jnp.log(jnp.clip(x, 1e-12)))


def t_dirichlet_logf(x):
    return torch.sum(torch.as_tensor(ALPHA - 1) * torch.log(
        torch.clamp(x, min=1e-12)), -1)


def _simplex_row(per_chain, K):
    """JAX's draws per chain for one row -> the port's batched layout: the
    levels (C,); the first batch (TRIPS + 2, C, K): first simplex weights,
    first point, the first ``TRIPS`` trips; then one (TRIPS, C, K) per
    further batch.  A chain with fewer trips, and a trip past the deepest
    chain's last, gets filler (its draw is spent)."""
    levels = [ev[0][1] for ev in per_chain]
    dirs = [[v for k, v in ev if k == "dirichlet"] for ev in per_chain]
    assert all(ev[0][0] == "uniform" for ev in per_chain)
    T = tss.TRIPS
    trips = max(len(d) for d in dirs) - 2
    slots = 2 + max(1, -(-trips // T)) * T
    rows = [1.0 - np.exp(-np.stack([d[t] if t < len(d) else np.full(K, 1.0 / K)
                                    for d in dirs])) for t in range(slots)]
    return (np.array(levels), np.stack(rows[:T + 2]),
            [np.stack(rows[a:a + T]) for a in range(T + 2, slots, T)])


def _simplex_feed(rows_per_chain, K):
    """The draws of a node's rows, one list of per-chain events per row, in
    the port's order, chain first: levels (C, R), first batches (C, R,
    TRIPS + 2, K), then each row's further batches (C, TRIPS, K)."""
    rows = [_simplex_row(per_chain, K) for per_chain in rows_per_chain]
    # chain first, as the port's keyed draws come
    return ([np.stack([r[0] for r in rows]).T,
             np.stack([r[1] for r in rows]).transpose(2, 0, 1, 3)]
            + [b.transpose(1, 0, 2) for r in rows for b in r[2]])


@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_slicesimplex_step_matches_given_the_same_draws(scale, monkeypatch):
    K = len(ALPHA)
    x0 = np.random.default_rng(4).dirichlet(np.ones(K) * 2, C)
    jtune = jss.SliceSimplexTune(scale=jnp.asarray(scale))
    j_out, events = [], []
    for c in range(C):
        (x2, _), ev = _recorded(monkeypatch, lambda: jss.slicesimplex_step(
            jax.random.key(50 + c), jnp.asarray(x0[c]), jtune, j_dirichlet_logf),
            kinds=("uniform", "dirichlet"))
        j_out.append(np.asarray(x2))
        events.append(ev)
    trips = [sum(k == "dirichlet" for k, _ in ev) - 2 for ev in events]
    assert max(trips) >= 1, trips              # the shrink loop ran
    ttune = convert.slicesimplex_tune({"scale": np.full(C, scale)}, "cpu",
                                      torch.float64)
    with fed(monkeypatch, rand=_simplex_feed([events], K)):
        x2, _ = tss.slicesimplex_step(KEYS, _t(x0), ttune, t_dirichlet_logf)
    np.testing.assert_allclose(x2.numpy(), np.stack(j_out), rtol=RTOL, atol=1e-15)


def test_slicesimplex_step_matches_over_several_batches(monkeypatch):
    # a peaked target, every chain started near its mode: the first points
    # are rejected for more than one batch of trips, so the feed holds
    # further batches with filler
    alpha = np.array([300.0, 2.0, 2.0, 200.0])
    K = len(alpha)
    mode = (alpha - 1) / (alpha - 1).sum()
    x0 = 0.98 * mode + 0.02 * np.random.default_rng(5).dirichlet(np.ones(K), C)
    jtune = jss.SliceSimplexTune(scale=jnp.asarray(1.0))
    j_out, events = [], []
    for c in range(C):
        (x2, _), ev = _recorded(monkeypatch, lambda: jss.slicesimplex_step(
            jax.random.key(60 + c), jnp.asarray(x0[c]), jtune,
            lambda x: jnp.sum((alpha - 1) * jnp.log(jnp.clip(x, 1e-12)))),
            kinds=("uniform", "dirichlet"))
        j_out.append(np.asarray(x2))
        events.append(ev)
    feed = _simplex_feed([events], K)
    assert len(feed) > 2, len(feed)
    ttune = convert.slicesimplex_tune({"scale": np.full(C, 1.0)}, "cpu",
                                      torch.float64)

    def t_logf(x):
        return torch.sum(torch.as_tensor(alpha - 1) * torch.log(
            torch.clamp(x, min=1e-12)), -1)

    with fed(monkeypatch, rand=feed):
        x2, _ = tss.slicesimplex_step(KEYS, _t(x0), ttune, t_logf)
    np.testing.assert_allclose(x2.numpy(), np.stack(j_out), rtol=RTOL, atol=1e-15)


def test_slicesimplex_targets_dirichlet():
    # the JAX package's test of the same name, over chains
    alpha = np.array([3.0, 1.0, 1.0])

    def logf(x):
        return torch.sum(torch.as_tensor(alpha - 1) * torch.log(
            torch.clamp(x, min=1e-12)), -1)

    gen = R.chain_keys(3, range(16))
    x = torch.full((16, 3), 1.0 / 3, dtype=torch.float64)
    tune = tss.slicesimplex_init(x, 0.7)
    draws = []
    for i in range(400):
        x, _ = tss.slicesimplex_step(R.fold_in(gen, i), x, tune, logf)
        if i >= 100:
            draws.append(x.numpy())
    d = np.concatenate(draws)
    np.testing.assert_allclose(d.sum(1), 1.0, atol=1e-12)
    assert (d > 0).all()
    np.testing.assert_allclose(d.mean(0), [0.6, 0.2, 0.2], atol=0.03)


def test_slicesimplex_validates_its_start_and_scale():
    with pytest.raises(ValueError, match="probability vector"):
        tss.slicesimplex_init(_t([[0.5, 0.6]]), 0.5)
    with pytest.raises(ValueError, match="scale"):
        tss.slicesimplex_init(_t([[0.5, 0.5]]), 1.5)
    with pytest.raises(ValueError, match="scale"):
        tmt.SliceSimplex("p", scale=0.0)
    # the row check holds a float32 point that came out of V @ xb
    tss.slicesimplex_init(torch.tensor([[0.2, 0.3, 0.5]], dtype=torch.float32), 1.0)


def test_slicesimplex_row_sweep_matches_the_jax_block(monkeypatch):
    # asthma's (3, 5) Dirichlet node: one shrinking-simplex pass per row,
    # one row after another against the block density, in both packages
    from mamba_tpu.models import asthma as jasthma
    from mamba_tpu_torch.models import asthma as tasthma
    tm, tin, tinits = tasthma.build()
    jm, jin, jinits = jasthma.build()
    tcm = tmt.compile_model(tm, tin, tinits[0], device="cpu")
    jcm = jmt.compile_model(jm, jin, jinits[0])
    q0 = np.stack([tinits[c % 3]["q"] for c in range(C)])
    state = {"y": np.broadcast_to(tasthma.Y, (C,) + tasthma.Y.shape).copy(), "q": q0}
    jblock = jm.samplers[0].build(jcm)
    j_q, events = [], []
    for c in range(C):
        jst = {k: jnp.asarray(v[c]) for k, v in state.items()}
        (st, _), ev = _recorded(monkeypatch, lambda: jblock.step(
            jax.random.key(70 + c), jst, jblock.init(jax.random.key(0), jst),
            False), kinds=("uniform", "dirichlet"))
        j_q.append(np.asarray(st["q"]))
        events.append(ev)
    # split each chain's draws into its three row passes (a pass starts
    # with its level)
    rows = []
    for ev in events:
        starts = [i for i, (k, _) in enumerate(ev) if k == "uniform"] + [len(ev)]
        rows.append([ev[a:b] for a, b in zip(starts, starts[1:])])
    assert all(len(r) == 3 for r in rows)
    feed = _simplex_feed([[rows[c][r] for c in range(C)] for r in range(3)], 5)
    tblock = tm.samplers[0].build(tcm)
    tstate = convert.to_tensors(state, "cpu", torch.float64)
    with fed(monkeypatch, rand=feed):
        st, _ = tblock.step(KEYS, tstate, tblock.init(KEYS, tstate), False)
    np.testing.assert_allclose(st["q"].numpy(), np.stack(j_q), rtol=RTOL, atol=1e-15)


# ---------------------------------------------------------------------------
# DGS
# ---------------------------------------------------------------------------

LOGP = np.log(np.array([[0.1, 0.6, 0.3], [0.7, 0.3, 0.0], [0.25, 0.25, 0.5]]))


def j_table_logf(x):
    idx = x.astype(jnp.int32)
    return jnp.sum(jnp.asarray(LOGP)[jnp.arange(3), idx])


def t_table_logf(x):
    idx = x.long()
    table = torch.as_tensor(LOGP)
    return torch.sum(table[torch.arange(3), idx], -1)


def test_dgs_step_matches_given_the_same_draws(monkeypatch):
    grid = np.array([[0.0, 1.0, 2.0], [0.0, 1.0, 2.0], [0.0, 1.0, 2.0]])
    mask = np.array([[True] * 3, [True, True, False], [True] * 3])
    jtune = jdgs.DGSTune(support=jnp.asarray(grid), mask=jnp.asarray(mask))
    x0 = np.random.default_rng(1).integers(0, 2, (C, 3)).astype(float)
    j_out, gumbels = [], []
    for c in range(C):
        (x2, _), ev = _recorded(monkeypatch, lambda: jdgs.dgs_step(
            jax.random.key(90 + c), jnp.asarray(x0[c]), jtune, j_table_logf),
            kinds=("gumbel",))
        j_out.append(np.asarray(x2))
        gumbels.append([v for _, v in ev])
    feed = [np.exp(-np.exp(-np.stack([np.stack(g) for g in gumbels])))]
    ttune = convert.dgs_tune({"support": np.broadcast_to(grid, (C, 3, 3)),
                              "mask": np.broadcast_to(mask, (C, 3, 3))},
                             "cpu", torch.float64)
    with fed(monkeypatch, rand=feed):
        x2, _ = tdgs.dgs_step(KEYS, _t(x0), ttune, t_table_logf)
    np.testing.assert_array_equal(x2.numpy(), np.stack(j_out))
    assert (x2[:, 1] != 2).all()                       # masked out


def test_dgs_draws_the_exact_conditionals():
    # independent elements with known masses (the JAX package's test)
    tune = tdgs.DGSTune(support=_t([[0.0, 1.0], [0.0, 1.0]]),
                        mask=torch.ones(2, 2, dtype=torch.bool))
    logp = torch.log(torch.tensor([[0.1, 0.9], [0.7, 0.3]], dtype=torch.float64))

    def logf(x):
        return logp[0, x[..., 0].long()] + logp[1, x[..., 1].long()]

    x, _ = tdgs.dgs_step(R.chain_keys(1, range(8000)),
                         torch.zeros(8000, 2, dtype=torch.float64), tune, logf)
    np.testing.assert_allclose(x.mean(0).numpy(), [0.9, 0.3], atol=0.03)


def test_dgs_ragged_support_and_the_uniform_fallback():
    # element 2 has a shorter support; a density that is -inf everywhere
    # falls back to a uniform draw over each element's valid support
    tune = tdgs.DGSTune(support=_t([[0.0, 1.0, 2.0], [0.0, 1.0, 0.0]]),
                        mask=torch.tensor([[True, True, True], [True, True, False]]))
    gen = R.chain_keys(2, range(6000))
    x0 = torch.zeros(6000, 2, dtype=torch.float64)
    for logf in (lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype),
                 lambda x: torch.full(x.shape[:-1], -torch.inf, dtype=x.dtype)):
        x, _ = tdgs.dgs_step(gen, x0, tune, logf)
        d = x.numpy()
        assert set(np.unique(d[:, 0])) == {0.0, 1.0, 2.0}
        assert set(np.unique(d[:, 1])) == {0.0, 1.0}
        np.testing.assert_allclose((d[:, 0] == 2.0).mean(), 1 / 3, atol=0.03)
        np.testing.assert_allclose((d[:, 1] == 1.0).mean(), 0.5, atol=0.03)


@pytest.mark.parametrize("which", ["Categorical", "Bernoulli", "Binomial"])
def test_dgs_support_matches_the_jax_grid(which):
    p = np.random.default_rng(5).dirichlet(np.ones(3), 4)
    n = np.array([2.0, 5.0, 3.0, 1.0])
    make = {"Categorical": lambda m, t: m.Categorical(t(p)),
            "Bernoulli": lambda m, t: m.Bernoulli(t(p[:, 0])),
            "Binomial": lambda m, t: m.Binomial(t(n), t(p[:, 0]))}[which]
    tt = tdgs.dgs_support(make(tmt, _t), (4,))
    jt = jdgs.dgs_support(make(jmt, jnp.asarray), (4,))
    np.testing.assert_array_equal(tt.support.numpy(), np.asarray(jt.support))
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))


def test_dgs_requires_a_discrete_node():
    model = tmt.Model(a=tmt.Stochastic(lambda: tmt.Normal(0.0, 1.0)))
    model.set_samplers([tmt.DGS("a")])
    cm = tmt.compile_model(model, {}, {"a": 0.0}, device="cpu")
    with pytest.raises(ValueError, match="discrete"):
        model.samplers[0].build(cm)
    model = tmt.Model(a=tmt.Stochastic(lambda: tmt.Poisson(3.0)))
    model.set_samplers([tmt.DGS("a")])
    cm = tmt.compile_model(model, {}, {"a": 1.0}, device="cpu")
    model.samplers[0].build(cm)          # bounded by mean + 10 sd: finite


def test_discrete_step_exact_masses():
    # the stand-alone DiscreteVariate form (reference dgs.jl:129-133)
    mass = torch.tensor([0.2, 0.5, 0.3], dtype=torch.float64).expand(6000, 3)
    draws = tmt.samplers.discrete_step(R.key(0),
                                       _t([0.0, 1.0, 2.0]), mass).numpy()
    assert draws.shape == (6000,)
    freqs = [(draws == v).mean() for v in (0.0, 1.0, 2.0)]
    np.testing.assert_allclose(freqs, [0.2, 0.5, 0.3], atol=0.02)
    rows = tmt.samplers.discrete_step(R.key(1),
                                      _t([[0.0, 1.0], [2.0, 3.0]]),
                                      _t([0.0, 1.0]))
    assert rows.tolist() == [2.0, 3.0]
