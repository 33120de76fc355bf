"""The last samplers that ran eagerly, on captured steps (``utils/graphs.py``)
on the CPU: BIA, BMC3 and BMG, whose draws are made before their step's
body, and ABC and MISS, whose bodies draw from the chains' keys held in
their buffers (the simulations and imputations draw inside the
distributions' ``sample``).  Each captured step against its plain loop, bit
for bit: the stand-alone binary steps through one
``Captured`` reused step after step; the ABC and MISS block kernels built
by the engine, through the plain loop (``graphs.disabled()``), through the
captured form on the CPU (the bodies run eagerly on the ``Captured``'s own
tensors) and through the card's path emulated (warm-ups, captures that do
not run, replays).  The CUDA graphs themselves are held to the plain loops
on the card by ``chip_smoke.py``'s graphs phase."""

import contextlib
import functools

import numpy as np
import pytest
import torch

import mamba_tpu_torch as tmt
from mamba_tpu_torch.ops import random as R
from mamba_tpu_torch.model.mcmc import _chain_inits
from mamba_tpu_torch.models import bones, kidney, mice
from mamba_tpu_torch.samplers import abc as tabc
from mamba_tpu_torch.samplers import base
from mamba_tpu_torch.samplers import binary as tbin
from mamba_tpu_torch.utils import graphs
from test_torch_graphs import _assert_tunes_equal
from test_torch_graphs_zoo import C, _both, _emulate_the_card, _t

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# BIA, BMC3, BMG: the draws before the body
# ---------------------------------------------------------------------------

def _binary_density(x, state):
    """Independent Bernoulli coordinates and a pull between the first two."""
    p = state["p"]
    lf = torch.sum(x * torch.log(p) + (1 - x) * torch.log1p(-p), -1)
    return lf + (0.7 * x[:, 0] * x[:, 1] if x.shape[1] > 1 else 0.0)


def _binary_case(n, seed):
    rng = np.random.default_rng(seed)
    return (_t(rng.integers(0, 2, (C, n))),
            {"p": _t(rng.uniform(0.15, 0.85, (C, n)))})


def test_bia_captured_step_equals_the_plain_step():
    x0, state = _binary_case(4, 1)
    tune0 = tbin.bia_init(x0)
    tunes = {}

    def step(key, x, cap, f):
        x2, t2 = tbin.bia_step(key, x, tunes.get(cap is None, tune0), f,
                               graphed=cap)
        tunes[cap is None] = t2
        return x2

    _both(step, tbin.bia_bodies, _binary_density, x0, state, steps=5)
    _assert_tunes_equal((tunes[False],), (tunes[True],))
    assert tunes[True].iter == 5
    assert not torch.equal(tunes[True].A, tune0.A)       # the adaptation moved


#: k coordinates flipped or proposed, or one of these groups (k == 0)
INDEX_K = {"k1": 1, "k2": 2, "groups": [[0], [1, 2], [0, 1, 2, 3]]}


@pytest.mark.parametrize("kernel", ["bmc3", "bmg"])
@pytest.mark.parametrize("k", sorted(INDEX_K))
def test_index_captured_steps_equal_the_plain_steps(kernel, k):
    x0, state = _binary_case(4, 2)
    init, step_fn, bodies = {
        "bmc3": (tbin.bmc3_init, tbin.bmc3_step, tbin.bmc3_bodies),
        "bmg": (tbin.bmg_init, tbin.bmg_step, tbin.bmg_bodies)}[kernel]
    tune = init(x0, INDEX_K[k])
    assert tune.k == (0 if k == "groups" else INDEX_K[k])
    _both(lambda key, x, cap, f: step_fn(key, x, tune, f, graphed=cap)[0],
          functools.partial(bodies, k=tune.k), _binary_density, x0, state,
          steps=5)


def test_bmg_captured_step_of_one_coordinate_equals_the_plain_step(
        monkeypatch):
    # n == 1: the proposal is taken as it is, and no acceptance is drawn
    x0, state = _binary_case(1, 3)
    tune = tbin.bmg_init(x0, 1)
    _both(lambda key, x, cap, f: tbin.bmg_step(key, x, tune, f, graphed=cap)[0],
          functools.partial(tbin.bmg_bodies, k=1), _binary_density, x0, state,
          steps=4)
    draws = []
    inner = R.uniform
    monkeypatch.setattr(R, "uniform", lambda *a, **k: draws.append(a[1]) or
                        inner(*a, **k))
    tbin.bmg_step(R.chain_keys(7, range(C)), x0, tune,
                  base.candidate_logf(_binary_density, state))
    assert draws == [(1,), (1,)]         # the index draw, the proposals


# ---------------------------------------------------------------------------
# ABC and MISS: the engine's block kernels, whose bodies draw
# ---------------------------------------------------------------------------

def _block_ways(monkeypatch, build, block=0, steps=3, chains=3, seed=3):
    """``steps`` steps of block ``block`` of the model ``build()`` gives,
    built by the engine three ways: its plain loop (``graphs.disabled()``),
    its captured step on the CPU and the card's path emulated.  Checks that
    all three give the same states and tunes, step ``i`` from the same
    keys, and test the host as often; returns the host tests and the card
    way's replays."""
    out = {}
    for way in ("plain", "captured", "card"):
        model, inputs, inits = build()
        cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
        with monkeypatch.context() as m:
            if way == "card":
                _emulate_the_card(m)
            with graphs.disabled() if way == "plain" else contextlib.nullcontext():
                kernel = model.samplers[block].build(cm)
            state = _chain_inits(cm, inits, chains)
            keys = R.chain_keys(seed, range(chains))
            tune = kernel.init(keys, state)
            before = dict(graphs.STATS)
            seq = []
            for i in range(steps):
                state, tune = kernel.step(R.fold_in(keys, i), state, tune,
                                          True)
                seq.append({k: v.clone() for k, v in state.items()})
            out[way] = (seq, tune,
                        graphs.STATS["host_tests"] - before["host_tests"],
                        graphs.STATS["replays"] - before["replays"])
    plain = out["plain"]
    for way in ("captured", "card"):
        seq, tune, tests, _ = out[way]
        for a, b in zip(seq, plain[0]):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), (way, k)
        _assert_tunes_equal((tune,), (plain[1],))
        assert tests == plain[2], (way, tests, plain[2])
    assert out["card"][3] > 0 and out["plain"][3] == out["captured"][3] == 0
    return plain[2], out["card"][3]


def _abc_model(maxdraw, randeps):
    """y ~ N(mu, 1), mu ~ N(0, 10) under ABC with a tight tolerance, so that
    many chains reject a batch of draws and the next batch runs."""
    y = np.array([0.8, 1.2, 1.1, 0.9, 1.3, 0.7, 1.0, 1.05])
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu: tmt.Normal(mu.expand(len(y)), 1.0),
                         monitor=False),
        mu=tmt.Stochastic(lambda: tmt.Normal(0.0, np.sqrt(10.0))),
    )
    model.set_samplers([tmt.ABC("mu", scale=2.0, summary=lambda x: torch.mean(x),
                                epsilon=0.02, maxdraw=maxdraw, nsim=2,
                                decay=0.75, randeps=randeps)])
    return model, {}, [{"y": y, "mu": 0.0}, {"y": y, "mu": 3.0}]


#: under, at and over one batch of ``DRAWS_PER_CALL`` draws (60: a first
#: body of 10 draws, then two of 25)
ABC_MAXDRAW = [10, tabc.DRAWS_PER_CALL, 60]


@pytest.mark.parametrize("randeps", [False, True])
@pytest.mark.parametrize("maxdraw", ABC_MAXDRAW)
def test_abc_captured_batches_equal_the_plain_loop(maxdraw, randeps, monkeypatch):
    # eight chains, so that in some step a chain rejects a whole batch
    tests, replays = _block_ways(
        monkeypatch, lambda: _abc_model(maxdraw, randeps), steps=4, chains=8)
    batches = -(-maxdraw // tabc.DRAWS_PER_CALL)
    if batches == 1:
        assert tests == 0 and replays == 4
    else:
        # a replay per batch, a host test after every batch but the one a
        # step ends at its limit with; some steps took more than one
        assert 4 < replays <= 4 * batches and 4 <= tests <= replays


@pytest.mark.parametrize("name", ["bones", "kidney", "mice"])
def test_miss_captured_imputation_equals_the_plain_loop(name, monkeypatch):
    # bones imputes Categorical grades, kidney and mice Truncated(Weibull)
    # times, through isf_log
    build = {"bones": bones.build, "kidney": kidney.build, "mice": mice.build}[name]
    tests, replays = _block_ways(monkeypatch, build, steps=3, chains=2)
    assert tests == 0 and replays == 3
