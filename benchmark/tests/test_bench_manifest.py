"""BENCHMARK.json against the benchmark's contract, and every name found
by its file; a new cell and a new metric need only new files."""

import json
import re
import shutil

import numpy as np

from benchmark import job
from benchmark.manifest import ROOT, Manifest

from _tiny import TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and len(b["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == []
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
        cells.add(w["name"])
    assert {w["config"] for w in b["workloads"]} == names
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert e2e["setup_s"]["bound"] == 0.25
    layers = set()
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers.add(m["layer"])
    every = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in every}) == len(every)
    for m in every:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    man = Manifest()
    for cell in cells:
        reported = {m["name"] for m in man.metrics("end_to_end", cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert man.metrics("per_layer", cell)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_has_its_files():
    man = Manifest()
    for m in man.bench["end_to_end"] + man.bench["per_layer"]:
        assert callable(man.reader(m["name"]).read)
    for c in man.bench["configs"]:
        cfg = man.config(c["name"])
        ref = man.reference(c["name"])
        assert set(cfg["monitored"]) and callable(ref.block_logp_grad)
        assert callable(man.adapter(c["name"]).build)
    for w in man.bench["workloads"]:
        t = man.traffic(w["traffic"])
        gibbs = hasattr(man.reference(w["config"]), "gibbs_pit")
        # the density, its gradient, the draws, and one number of the
        # transitions: the one that separates a planted fault in the cell
        base = {"lp_gap", "grad_gap", "draw_gap", "unmoved"}
        moves = set(t["limits"]) - base - {"gibbs_ks"}
        assert base <= set(t["limits"]) and len(moves & {"score_z", "stein_z"}) == 1
        assert moves <= {"score_z", "stein_z"}
        assert ("gibbs_ks" in t["limits"]) == gibbs


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    t = json.loads((ROOT / "benchmark/workloads/glmm10k-chees.json").read_text())
    t.update(TINY["glmm10k-chees"]["traffic"])
    (tmp_path / "benchmark/workloads/glmm10k-small.json").write_text(json.dumps(t))
    (tmp_path / "benchmark/metrics/window_iters.py").write_text(
        '"""Kept iterations of the window."""\n\n\n'
        'def read(run):\n    return run.iters\n')
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "glmm10k-small", "config": "glmm10k",
                           "traffic": "glmm10k-small", "chips": 1,
                           "why": "a small job"})
    b["end_to_end"].append({"name": "window_iters", "unit": "iters",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["glmm10k-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    man = Manifest(tmp_path)
    res, checks, rec = job.run(man, "glmm10k-small", 5, 0.1, False,
                               device="cpu", log=lambda *a: None,
                               overrides={"config": {"G": 64}})
    assert res["correct"], checks
    assert res["metrics"]["window_iters"]["value"] == rec.iters >= 40
    assert {"draws_per_s", "setup_s"} <= set(res["metrics"])
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: after[k] for k in before} == before
    assert np.isfinite(rec.window_s)
