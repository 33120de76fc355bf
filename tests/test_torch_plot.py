"""The port's plot engines and paginated drawing (reference
src/output/plot.jl), the cases of tests/test_plot.py: the same plot counts
per type as the JAX package's, pages written to files (SVG by the port's
own writer, without matplotlib), and the progress meter of a port run."""

import os

import numpy as np
import pytest
import torch

import mamba_tpu as jmt
import mamba_tpu_torch as tmt

torch.set_num_threads(2)


def _chains(pkg):
    rng = np.random.default_rng(0)
    v = np.stack([rng.normal(0, 1, (500, 2)),
                  rng.normal(0.2, 1, (500, 2))], axis=2)
    disc = rng.integers(0, 3, (500, 1, 2)).astype(float)
    return pkg.Chains(np.concatenate([v, disc], 1), start=11, thin=2,
                      names=["a", "b", "k"])


@pytest.fixture(scope="module")
def sims():
    return _chains(jmt), _chains(tmt)


@pytest.mark.parametrize("ptype,count", [
    (("trace", "density"), 6), (["autocor", "mean", "bar"], 9),
    ("contour", 3), (["mixeddensity"], 3)])
def test_plot_types_and_counts(sims, ptype, count):
    jsim, tsim = sims
    t, j = tmt.plot(tsim, ptype), jmt.plot(jsim, ptype)
    assert len(t) == len(j) == count
    assert [s.title for s in t] == [s.title for s in j]
    with pytest.raises(ValueError):
        tmt.plot(tsim, ["nope"])


def test_draw_pagination(tmp_path, sims):
    _, tsim = sims
    p = tmt.plot(tsim, ["trace", "density"])     # 6 plots
    files = tmt.draw(p, fmt="png", filename=os.path.join(tmp_path, "x"),
                     nrow=2, ncol=2)
    assert len(files) == 2                        # 6 plots / 4 per page
    for f in files:
        assert os.path.getsize(f) > 3000
    svg = tmt.draw(tmt.plot(tsim, "autocor"), fmt="svg",
                   filename=os.path.join(tmp_path, "a.svg"))
    assert svg == [os.path.join(tmp_path, "a.svg")]
    with pytest.raises(ValueError):
        tmt.draw(p, fmt="bmp", filename=os.path.join(tmp_path, "y"))


@pytest.mark.parametrize("ptype", ["trace", "density", "mean", "autocor",
                                   "bar", "contour", "mixeddensity"])
def test_svg_pages_need_no_matplotlib(tmp_path, sims, ptype, monkeypatch):
    """SVG pages are written by the port's own writer: with matplotlib
    made unimportable, each plot type still gives well-formed pages, one
    panel title per plot."""
    import sys
    from xml.dom import minidom
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _, tsim = sims
    specs = tmt.plot(tsim, ptype)
    files = tmt.draw(specs, fmt="svg", filename=os.path.join(tmp_path, ptype),
                     nrow=2, ncol=2)
    assert len(files) == -(-len(specs) // 4)
    titles = []
    for f in files:
        doc = minidom.parse(f)
        texts = [t.firstChild.data for t in doc.getElementsByTagName("text")
                 if t.firstChild is not None]
        titles += [t for t in texts if t in {s.title for s in specs}]
        assert doc.getElementsByTagName("rect")
    assert sorted(titles) == sorted(s.title for s in specs)
    with pytest.raises(ImportError):
        tmt.draw(specs, fmt="png", filename=os.path.join(tmp_path, "p"))


def test_progress_meter_runs(capsys):
    from mamba_tpu_torch.models import line
    model, inputs, inits = line.build()
    model.set_samplers([tmt.HMC("beta", 0.1, 5), tmt.Slice("s2", 3.0)])
    sim = tmt.mcmc(model, inputs, inits, 60, burnin=20, chains=2,
                   verbose=False, progress=True, device="cpu")
    out = capsys.readouterr().out
    assert "60 Iterations x 2 Chains" in out and "100%" in out
    assert "remaining]" in out
    assert sim.niter == 40
