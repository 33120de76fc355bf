"""A run with its timed path broken underneath comes out not correct, once
for each fault a cell can have:

- a step that returns its state unchanged;
- half of the batch left out, the mean taken over the rest;
- an answer altered where it is produced (a kept draw, a gradient);
- a transition that leaves the posterior: ChEES's accept test dropped,
  NUTS's tree sampled without its energies, the Gibbs block's conditional
  at the wrong rate (``benchmark/faults.py``).

The exchange between chips is no fault of these cells: each runs on one
chip, and every cell of ``BENCHMARK.json`` asks for one
(``test_bench_manifest``).  The faults are planted here, in the test's
process; the benchmark patches nothing.
"""

import pytest
import torch

import mamba_tpu_torch as mt
from mamba_tpu_torch.model.compile import CompiledModel
from mamba_tpu_torch.samplers.base import BlockKernel

from benchmark import faults, job
from benchmark.manifest import Manifest

from _tiny import TINY


def _run(cell, seed=4):
    return job.run(Manifest(), cell, seed, 0.1, False, device="cpu",
                   log=lambda *a: None, overrides=TINY[cell])


def test_sound_runs_are_correct():
    for cell in ("glmm10k-chees", "rats-nuts"):
        res, checks, _ = _run(cell)
        assert res["correct"], (cell, checks)


@pytest.mark.parametrize("cell,cls", [("glmm10k-chees", "ChEESHMC"),
                                      ("rats-nuts", "NUTS")])
def test_a_step_that_returns_its_state_unchanged(monkeypatch, cell, cls):
    orig = getattr(mt, cls).build

    def build(self, cm):
        k = orig(self, cm)
        return BlockKernel(k.init, lambda key, state, tune, adapt:
                           (state, k.step(key, state, tune, adapt)[1]))

    monkeypatch.setattr(getattr(mt, cls), "build", build)
    res, checks, rec = _run(cell)
    assert not res["correct"]
    assert checks["unmoved"]["value"] == rec.chains


def test_half_of_the_batch_left_out(monkeypatch):
    orig = CompiledModel.block_density

    def block_density(self, *a, **kw):
        density = orig(self, *a, **kw)

        def half(x, state):
            lp, g = density(x, state)
            h = lp.shape[0] // 2
            lp = torch.cat([lp[:h], lp[:h].mean().expand(lp.shape[0] - h)])
            g = torch.cat([g[:h], g[:h].mean(0).expand(g.shape[0] - h, -1)])
            return lp, g
        return half if kw.get("grad") else density

    monkeypatch.setattr(CompiledModel, "block_density", block_density)
    res, checks, _ = _run("glmm10k-chees")
    assert not res["correct"]
    # outside its limit, as the check judges it: over it, or NaN where the
    # chains that see the mean diverge
    assert not checks["lp_gap"]["value"] <= checks["lp_gap"]["limit"]


def test_a_kept_draw_altered_where_it_is_produced(monkeypatch):
    orig = CompiledModel.monitor_rows

    def monitor_rows(self):
        rows = orig(self)

        def altered(state):
            out = rows(state).clone()
            out[0, 0] = out[0, 0] * 1.001
            return out
        return altered

    monkeypatch.setattr(CompiledModel, "monitor_rows", monitor_rows)
    res, checks, _ = _run("glmm10k-chees")
    assert not res["correct"]
    assert checks["draw_gap"]["value"] > checks["draw_gap"]["limit"]


def test_a_gradient_altered_where_it_is_produced(monkeypatch):
    orig = CompiledModel.block_density

    def block_density(self, *a, **kw):
        density = orig(self, *a, **kw)

        def altered(x, state):
            lp, g = density(x, state)
            return lp, g * (1.0 + 0.1 * (torch.arange(g.shape[0]) == 0)[:, None])
        return altered if kw.get("grad") else density

    monkeypatch.setattr(CompiledModel, "block_density", block_density)
    res, checks, _ = _run("glmm10k-chees")
    assert not res["correct"]
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]


@pytest.mark.parametrize("cell,fault,number", [
    ("glmm10k-chees", "always_accept", "stein_z"),
    ("rats-nuts", "slice_ignores_energy", "score_z"),
    ("rats-nuts", "gibbs_rate_doubled", "gibbs_ks"),
])
def test_a_transition_that_leaves_the_posterior(cell, fault, number):
    with faults.planted(fault):
        res, checks, _ = _run(cell)
    assert not res["correct"]
    assert checks[number]["value"] > checks[number]["limit"], checks
