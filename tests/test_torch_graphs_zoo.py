"""The zoo's samplers on captured steps (``utils/graphs.py``) on the CPU,
where a ``Captured`` runs its bodies eagerly on its own tensors: the steps
of Slice (both forms), SliceSimplex, AMWG, BHMC, AMM, RWM, HMC and MALA
(those of BIA, BMC3, BMG, ABC and MISS are in
``test_torch_graphs_eager.py``) through one ``Captured`` reused step after
step, against their plain loops
(fresh tensors every step), bit for bit, with one batch of trips and with
several; engine runs through the captured steps against
``graphs.disabled()`` runs; a restart; the host tests and replays counted;
and no captured body of any zoo model that waits for the device or copies
host data.  The CUDA graphs themselves are held to the plain loops on the
card by ``chip_smoke.py``'s graphs phase."""

import contextlib
import functools
import importlib

import numpy as np
import pytest
import torch

import mamba_tpu_torch as tmt
from mamba_tpu_torch.ops import random as R
from mamba_tpu_torch.models import line
from mamba_tpu_torch.samplers import abc as tabc
from mamba_tpu_torch.samplers import amm as tamm
from mamba_tpu_torch.samplers import amwg as tamwg
from mamba_tpu_torch.samplers import base
from mamba_tpu_torch.samplers import binary as tbin
from mamba_tpu_torch.samplers import hmc as thmc
from mamba_tpu_torch.samplers import mala as tmala
from mamba_tpu_torch.samplers import miss as tmiss
from mamba_tpu_torch.samplers import rwm as trwm
from mamba_tpu_torch.samplers import slice as tslice
from mamba_tpu_torch.samplers import slicesimplex as tss
from mamba_tpu_torch.utils import graphs
from _torch_card import _emulate_the_card
from test_torch_graphs import _assert_tunes_equal, _HostWatch

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64)
C, DIM, STEPS = 6, 3, 3


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _state(seed=0, dim=DIM):
    """Per-chain precisions and means: the state a block's density reads."""
    rng = np.random.default_rng(seed)
    return {"prec": _t(rng.uniform(0.5, 4.0, (C, dim))),
            "mean": _t(rng.normal(size=(C, dim)))}


def _gauss(x, state):
    """A batched Gaussian ``(N, dim) -> (N,)`` on ``N`` rows of state."""
    z = x - state["mean"]
    return -0.5 * torch.sum(state["prec"] * z * z, dim=-1)


def _gauss_grad(x, state):
    z = x - state["mean"]
    return -0.5 * torch.sum(state["prec"] * z * z, dim=-1), -state["prec"] * z


def _host_tests(fn):
    before = graphs.STATS["host_tests"]
    out = fn()
    return out, graphs.STATS["host_tests"] - before


def _both(step, bodies, density, x0, state, grad=False, steps=STEPS):
    """``steps`` steps of ``step(key, x, graphed)`` through one captured
    step and through the plain loop, step ``i`` from the same per-chain
    keys; checks that the two give the same values, and returns the plain
    steps' host tests."""
    cap = base.captured(bodies, density, grad=grad)
    cap.load_state(state)
    f = ((lambda x: density(x, state)) if grad
         else base.candidate_logf(density, state))
    outs, tests = {}, 0
    keys = R.chain_keys(7, range(x0.shape[0]))
    for way in ("captured", "plain"):
        x, seq = x0, []
        for i in range(steps):
            key = R.fold_in(keys, i)
            if way == "captured":
                x = step(key, x, cap, f)
            else:
                x, n = _host_tests(lambda x=x: step(key, x, None, f))
                tests += n
            seq.append(x.clone())
        outs[way] = seq
    for a, b in zip(outs["captured"], outs["plain"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert cap.graphs == {} and not cap.eager       # nothing captured on the CPU
    return tests


# ---------------------------------------------------------------------------
# the samplers' captured steps against their plain loops
# ---------------------------------------------------------------------------

#: bracket widths: narrow enough that every coordinate stops within its
#: first batch of trips, or wide enough that some need several
SLICE_WIDTHS = {"one_batch": 0.5, "several": 200.0}


@pytest.mark.parametrize("form", ["univariate", "multivariate"])
@pytest.mark.parametrize("case", sorted(SLICE_WIDTHS))
def test_slice_captured_step_equals_the_plain_loop(form, case):
    state = _state(1)
    x0 = _t(np.random.default_rng(2).normal(size=(C, DIM)))
    tune = tslice.slice_init(x0, SLICE_WIDTHS[case])
    fn = (tslice.slice_univariate_step if form == "univariate"
          else tslice.slice_multivariate_step)
    bodies = (tslice.univariate_bodies if form == "univariate"
              else tslice.multivariate_bodies)
    tests = _both(lambda key, x, g, f: fn(key, x, tune, f, graphed=g)[0],
                  bodies, _gauss, x0, state)
    batches = STEPS * (DIM if form == "univariate" else 1)
    # one host test per coordinate (or step) within one batch, more else
    assert (tests == batches) == (case == "one_batch"), tests


#: Dirichlet targets: a flat one, where most first points are accepted, and
#: a peaked one, where some rows shrink for several batches
SIMPLEX_ALPHA = {"one_batch": [1.5, 1.0, 1.2], "several": [400.0, 1.0, 300.0]}


@pytest.mark.parametrize("case", sorted(SIMPLEX_ALPHA))
def test_slicesimplex_captured_rows_equal_the_plain_loop(case):
    R, K = 2, 3
    alpha = _t(SIMPLEX_ALPHA[case])

    def density(x, state):
        rows = x.reshape(x.shape[0], R, K)
        return torch.sum((alpha - 1.0) * torch.log(torch.clamp(rows, min=1e-300)),
                         dim=(-1, -2)) * state["w"][:, 0]

    state = {"w": _t(np.random.default_rng(3).uniform(0.5, 1.0, (C, 1)))}
    x0 = _t(np.random.default_rng(4).dirichlet(np.ones(K) * 3, (C, R)))
    scale = torch.tensor(0.9, **F64)

    def step(key, x, cap, f):
        if cap is None:
            cap = base.plain(tss.simplex_bodies, f)
        return tss._rows_step(key, x, scale, cap, 1000)

    tests = _both(step, tss.simplex_bodies, density, x0, state)
    assert (tests == STEPS * R) == (case == "one_batch"), tests


@pytest.mark.parametrize("case", ["one_batch", "several"])
def test_bhmc_captured_trajectory_equals_the_plain_loop(case):
    n = 4
    p = _t(np.random.default_rng(5).uniform(0.2, 0.8, (C, n)))

    def density(x, state):
        return torch.sum(x * torch.log(state["p"]) + (1 - x) * torch.log1p(-state["p"]), -1)

    # a quarter turn hits a wall or two; ten turns hit dozens
    T = 0.25 * np.pi if case == "one_batch" else 10 * np.pi
    x0 = _t(np.random.default_rng(6).integers(0, 2, (C, n)))
    tune = tbin.bhmc_init(R.chain_keys(0, range(C)), x0, T)
    tunes = {}

    def step(key, x, cap, f):
        x2, t2 = tbin.bhmc_step(key, x, tune, f, graphed=cap)
        tunes.setdefault(cap is None, []).append(t2)
        return x2

    bodies = functools.partial(tbin.hit_bodies, traveltime=T)
    tests = _both(step, bodies, density, x0, {"p": p})
    for a, b in zip(tunes[False], tunes[True]):
        _assert_tunes_equal((a,), (b,))
    assert (tests == STEPS) == (case == "one_batch"), tests


@pytest.mark.parametrize("adapt", [False, True])
def test_amwg_captured_sweep_equals_the_plain_sweep(adapt):
    state = _state(7)
    x0 = _t(np.random.default_rng(8).normal(size=(C, DIM)))
    tune = tamwg.amwg_init(x0, [0.5, 1.0, 2.0], batchsize=2)
    tunes = {}

    def step(key, x, cap, f):
        x2, t2 = tamwg.amwg_step(key, x, tunes.get(cap is None, tune), f, adapt,
                                 graphed=cap)
        tunes[cap is None] = t2
        return x2

    _both(step, tamwg.sweep_bodies, _gauss, x0, state)
    _assert_tunes_equal((tunes[False],), (tunes[True],))
    assert tunes[True].m == (STEPS if adapt else 0)


def test_amm_captured_step_equals_the_plain_step():
    state = _state(9)
    x0 = _t(np.random.default_rng(10).normal(size=(C, DIM)))
    tune0 = tamm.amm_init(x0, 0.3 * np.eye(DIM), beta=0.2)
    tunes = {}

    def step(key, x, cap, f):
        x2, t2 = tamm.amm_step(key, x, tunes.get(cap is None, tune0), f, True,
                               graphed=cap)
        tunes[cap is None] = t2
        return x2

    # past 2 dim adaptation steps the mixture proposal takes over
    _both(step, functools.partial(tamm.step_bodies, beta=0.2), _gauss, x0,
          state, steps=2 * DIM + 3)
    _assert_tunes_equal((tunes[False],), (tunes[True],))
    assert int(tunes[True].m[0]) == 2 * DIM + 3


@pytest.mark.parametrize("proposal", ["normal", "uniform"])
def test_rwm_captured_step_equals_the_plain_step(proposal):
    x0 = _t(np.random.default_rng(11).normal(size=(C, DIM)))
    tune = trwm.rwm_init(x0, [0.5, 1.0, 0.3])
    _both(lambda key, x, cap, f: trwm.rwm_step(key, x, tune, f, proposal, cap)[0],
          functools.partial(trwm.step_bodies, proposal=proposal), _gauss, x0,
          _state(12))


def _sigma():
    R = np.array([[1.0, 0.3, -0.2], [0.3, 1.0, 0.1], [-0.2, 0.1, 1.0]])
    return 0.5 * R


@pytest.mark.parametrize("with_sigma", [False, True])
@pytest.mark.parametrize("L", [1, 5])
def test_hmc_captured_trajectory_equals_the_plain_loop(with_sigma, L):
    x0 = _t(np.random.default_rng(13).normal(size=(C, DIM)))
    tune = thmc.hmc_init(x0, 0.2, L, _sigma() if with_sigma else None)
    _both(lambda key, x, cap, f: thmc.hmc_step(key, x, tune, f, cap)[0],
          thmc.trajectory_bodies, _gauss_grad, x0, _state(14), grad=True)


@pytest.mark.parametrize("with_sigma", [False, True])
def test_mala_captured_step_equals_the_plain_step(with_sigma):
    x0 = _t(np.random.default_rng(15).normal(size=(C, DIM)))
    tune = tmala.mala_init(x0, 0.1, _sigma() if with_sigma else None)
    _both(lambda key, x, cap, f: tmala.mala_step(key, x, tune, f, cap)[0],
          tmala.step_bodies, _gauss_grad, x0, _state(16), grad=True)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

#: line's schemes of tests/test_torch_samplers_extra.py
LINE_SCHEMES = {
    "hmc_slice": lambda: [tmt.HMC("beta", 0.2, 4), tmt.Slice("s2", 1.0, transform=True)],
    "mala_slice": lambda: [tmt.MALA("beta", 0.05), tmt.Slice("s2", 3.0)],
    "rwm_slice_uni": lambda: [tmt.RWM("beta", np.array([1.0, 0.3])),
                              tmt.Slice("s2", 3.0, form="univariate")],
}


def _build(arm):
    name, _, scheme = arm.partition(":")
    if name == "line" and scheme:
        model, inputs, inits = line.build(chains=2)
        model.set_samplers(LINE_SCHEMES[scheme]())
        return model, inputs, inits
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    return mod.build(scheme) if scheme else mod.build()


def _spy_runs(monkeypatch):
    """Records whether each ``Captured.run`` was a captured one (not
    ``eager``) and keeps every captured ``Captured``."""
    seen = {"captured": 0, "plain": 0, "caps": []}
    real = graphs.Captured.run

    def run(self, n=1, name="body"):
        seen["plain" if self.eager else "captured"] += 1
        if not self.eager and all(c is not self for c in seen["caps"]):
            seen["caps"].append(self)
        return real(self, n, name)
    monkeypatch.setattr(graphs.Captured, "run", run)
    return seen


def _engine_pair(arm, monkeypatch, iters=4, burnin=2, chains=3, **kw):
    seen = _spy_runs(monkeypatch)
    sims = {}
    for way in ("captured", "plain"):
        model, inputs, inits = _build(arm)
        counts = dict(seen)
        if way == "plain":
            with graphs.disabled():
                sims[way] = tmt.mcmc(model, inputs, inits, iters, burnin=burnin,
                                     chains=chains, verbose=False, device="cpu", **kw)
        else:
            sims[way] = tmt.mcmc(model, inputs, inits, iters, burnin=burnin,
                                 chains=chains, verbose=False, device="cpu", **kw)
        runs = {k: seen[k] - counts[k] for k in ("captured", "plain")}
        if way == "captured":
            assert runs["captured"] > 0 and runs["plain"] == 0, runs
        else:
            assert runs["captured"] == 0 and runs["plain"] > 0, runs
    return sims["captured"], sims["plain"]


def _assert_same_run(a, b):
    np.testing.assert_array_equal(a.value, b.value)
    _assert_tunes_equal(a.states["tunes"], b.states["tunes"])
    for k in a.states["state"]:
        assert torch.equal(a.states["state"][k], b.states["state"][k]), k
    assert torch.equal(a.states["key"], b.states["key"])


#: models (and schemes) that hold every sampler the engine captures:
#: univariate Slice (pumps), AMWG with univariate Slice (magnesium), AMWG
#: with both forms (inhalers), SliceSimplex (asthma), BHMC, BIA, BMC3 and
#: BMG (pollution), AMM (seeds), HMC, MALA and RWM on line, ABC (line_abc:
#: a Normal y, 4 batches of draws; gk: a user distribution, 2 batches, with
#: and without randeps), and MISS on a Truncated(Weibull) site (mice,
#: kidney) and on a Categorical one (bones)
ENGINE_ARMS = ["pumps", "magnesium", "inhalers", "asthma", "pollution:bhmc",
               "seeds:reference", "line:hmc_slice", "line:mala_slice",
               "line:rwm_slice_uni", "pollution:bia", "pollution:bmc3",
               "pollution:bmg", "line_abc", "gk", "mice", "bones", "kidney"]


@pytest.mark.parametrize("arm", ENGINE_ARMS)
def test_engine_captured_steps_equal_the_plain_loops(arm, monkeypatch):
    captured, plain = _engine_pair(arm, monkeypatch)
    _assert_same_run(captured, plain)
    assert set(captured.timing) == {"setup_s", "sample_s", "fetch_s"}


def test_engine_restart_through_the_captured_steps_is_exact():
    model, inputs, inits = _build("inhalers")
    whole = tmt.mcmc(model, inputs, inits, 7, burnin=3, chains=3, seed=5,
                     verbose=False, device="cpu")
    part = tmt.mcmc(tmt.mcmc(model, inputs, inits, 5, burnin=3, chains=3,
                             seed=5, verbose=False, device="cpu"),
                    2, verbose=False)
    np.testing.assert_array_equal(part.value, whole.value)
    _assert_tunes_equal(part.states["tunes"], whole.states["tunes"])
    assert torch.equal(part.states["key"], whole.states["key"])


def test_engine_counts_a_host_test_per_batch_of_trips():
    # pumps: univariate Slice over (alpha, beta) and over theta's 10
    # coordinates, at least one host test per coordinate and iteration
    model, inputs, inits = _build("pumps")
    sim, tests = _host_tests(lambda: tmt.mcmc(
        model, inputs, inits, 5, burnin=2, chains=4, verbose=False, device="cpu"))
    assert tests >= 5 * 12 and sim.value.shape[0] == 3


def test_split_blocks_and_disabled_builds_take_the_plain_loops(monkeypatch):
    model, inputs, inits = _build("inhalers")
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
    made = []
    real = base.captured
    for mod in (tslice, tamwg):
        monkeypatch.setattr(mod, "captured",
                            lambda *a, **k: made.append(1) or real(*a, **k))
    for spec in model.samplers:
        spec.build(cm)
    assert len(made) == 3
    # only disabled() gives the plain loops
    with graphs.disabled():
        for spec in model.samplers:
            spec.build(cm)
    assert len(made) == 3
    # a block split over a data axis replays, cut at its collectives
    monkeypatch.setattr(cm, "block_split", lambda *a, **k: True)
    for spec in model.samplers:
        spec.build(cm)
    assert len(made) == 6
    # the blocks whose bodies draw (MISS on mice, ABC on line_abc) take
    # their plain loops under disabled() alone: split, and on a mesh with a
    # data axis, where a site is drawn whole, they replay
    flags = []
    real_drawing = base.drawing

    def drawing(bodies, eager=False):
        flags.append(eager)
        return real_drawing(bodies, eager)

    for mod in (tmiss, tabc):
        monkeypatch.setattr(mod, "drawing", drawing)

    for name, blocks in (("mice", 1), ("line_abc", 2)):
        model, inputs, inits = _build(name)
        cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
        ways = []
        for way in ("captured", "disabled", "split", "data_axis"):
            del flags[:]
            with monkeypatch.context() as m:
                if way == "split":
                    m.setattr(cm, "block_split", lambda *a, **k: True)
                if way == "data_axis":
                    m.setattr(cm.comm, "data_size", 2)
                with graphs.disabled() if way == "disabled" else contextlib.nullcontext():
                    for spec in model.samplers:
                        spec.build(cm)
            ways.append(list(flags))
        assert ways == ([[False] * blocks, [True] * blocks]
                        + [[False] * blocks] * 2), (name, ways)


# ---------------------------------------------------------------------------
# replays and host tests, counted as on a CUDA device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", ENGINE_ARMS)
def test_engine_through_emulated_captures_equals_the_plain_loops(arm, monkeypatch):
    # the card's path (warm-ups from the tensors as they stand, captures
    # that do not run, replays) on every body of every captured block
    before = dict(graphs.STATS)
    _emulate_the_card(monkeypatch)
    captured, plain = _engine_pair(arm, monkeypatch)
    _assert_same_run(captured, plain)
    assert graphs.STATS["graphs"] > before["graphs"]
    assert graphs.STATS["replays"] > before["replays"]


def test_until_done_counts_replays_host_tests_and_launches(monkeypatch):
    _emulate_the_card(monkeypatch)

    def kernel():
        graphs.count_launch(kernel)
    kernel.launches = 0

    def trips(b, state, k):
        for _ in range(k):
            kernel()
            b["n"].add_(1)
        b["more"].copy_(b["n"] < state["stop"])

    cap = graphs.Captured({"first": functools.partial(trips, k=3),
                           "more": functools.partial(trips, k=2)})
    before = dict(graphs.STATS)
    cap.load(n=torch.zeros((), dtype=torch.long),
             more=torch.zeros((), dtype=torch.bool))
    cap.load_state({"stop": torch.tensor(8)})
    drawn = []
    runs = graphs.until_done(cap, "first", "more", limit=10,
                             draw=lambda j: drawn.append(j))
    # 3 trips, then 2 per batch until 8: 3, 5, 7, 9; a test after each
    assert runs == 4 and drawn == [1, 2, 3] and int(cap.bufs["n"]) == 9
    delta = {k: graphs.STATS[k] - before[k] for k in before}
    assert delta["host_tests"] == 4 and delta["replays"] == 4 == cap.replays
    assert delta["graphs"] == 2
    # each capture's two warm-ups launch (3 + 3, 2 + 2); the capture's own
    # launches go to the tally, and every replay adds it: 3 + 2 + 2 + 2
    assert kernel.launches == 10 + 9
    # the limit ends the loop without a test
    cap.load(n=torch.zeros((), dtype=torch.long))
    assert graphs.until_done(cap, "first", "more", limit=2) == 2
    assert graphs.STATS["host_tests"] - before["host_tests"] == 5


@pytest.mark.parametrize("form", ["univariate", "multivariate"])
def test_an_eager_batch_ends_at_its_first_idle_trip(form, monkeypatch):
    # the plain loop ends a batch at the first trip that finds every chain
    # accepted; the card's path runs the batch's every trip, masked, and
    # both end on the same values
    _emulate_the_card(monkeypatch)
    calls = []

    def density(x, state):
        calls.append(1)
        return _gauss(x, state)

    state = _state(1)
    x0 = _t(np.random.default_rng(2).normal(size=(C, DIM)))
    tune = tslice.slice_init(x0, SLICE_WIDTHS["one_batch"])
    fn = (tslice.slice_univariate_step if form == "univariate"
          else tslice.slice_multivariate_step)
    bodies = (tslice.univariate_bodies if form == "univariate"
              else tslice.multivariate_bodies)
    cap = base.captured(bodies, density)
    cap.load_state(state)
    f = base.candidate_logf(density, state)
    outs = {}
    for way, graphed in (("card", cap), ("plain", None)):
        del calls[:]
        outs[way] = fn(R.chain_keys(7, range(C)), x0, tune, f,
                       graphed=graphed)[0]
        if way == "plain":
            # the entry density, per coordinate (or step) a first candidate
            # and fewer trips than a whole batch
            loops = DIM if form == "univariate" else 1
            assert loops < len(calls) - 1 < loops * (1 + tslice.TRIPS)
    assert cap.replays > 0
    assert torch.equal(outs["card"], outs["plain"])


def test_idle_reads_the_flags_only_in_an_eager_run():
    flags = torch.zeros(3, dtype=torch.bool)
    seen = []
    cap = graphs.Captured(lambda b, s: seen.append(graphs.idle(b["f"])),
                          eager=True)
    cap.load(f=flags)
    cap.run(1)
    cap.load(f=torch.tensor([False, True, False]))
    cap.run(1)
    cap.load(f=flags)
    cap.warm_up(cap.bodies["body"])     # two runs, which record every trip
    assert seen == [True, False, False, False] and not graphs.idle(flags)


# ---------------------------------------------------------------------------
# no captured body waits for the device or copies from the host
# ---------------------------------------------------------------------------

#: every zoo model and scheme with a block this slice captures
CAPTURING = ["asthma", "birats", "blocker", "bones", "dogs", "dyes", "epil",
             "epil:nuts", "equiv", "equiv:nuts", "eyes", "inhalers", "jaws",
             "kidney", "leuk", "lsat", "magnesium", "mice", "oxford",
             "oxford:nuts", "pollution:bhmc", "pumps", "rats:reference",
             "rats:nuts-slice", "salm", "seeds:reference", "seeds:nuts",
             "stacks", "surgical", "line:hmc_slice", "line:mala_slice",
             "line:rwm_slice_uni", "pollution:bia", "pollution:bmc3",
             "pollution:bmg", "line_abc", "gk"]


@pytest.mark.parametrize("arm", CAPTURING)
def test_zoo_captured_bodies_neither_sync_nor_copy_from_the_host(arm, monkeypatch):
    # the run takes the card's path (warm-ups, captures, replays), then
    # every captured body runs once more under the watch
    _emulate_the_card(monkeypatch)
    seen = _spy_runs(monkeypatch)
    model, inputs, inits = _build(arm)
    if arm == "kidney":
        inits = [inits[0]]
    tmt.mcmc(model, inputs, inits, 2, burnin=1, chains=2, verbose=False,
             device="cpu", dtype=torch.float32)
    kinds = {type(s).__name__ for s in model.samplers}
    captures = {"Slice", "SliceSimplex", "AMWG", "BHMC", "AMM", "RWM", "HMC",
                "MALA", "BIA", "BMC3", "BMG", "ABC", "MISS"} & kinds
    assert captures and seen["caps"]
    for cap in seen["caps"]:
        for name, body in cap.bodies.items():
            # a coordinate's or row's body moves to the next one: from -1
            for index in ("i", "row"):
                if index in cap.bufs:
                    cap.bufs[index].fill_(-1)
            with _HostWatch() as watch:
                body(cap.bufs, cap.state)
            assert watch.seen == [], (arm, name)
