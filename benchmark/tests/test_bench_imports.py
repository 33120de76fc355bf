"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or mamba_tpu (compared whole, so mamba_tpu_torch passes), and
nothing of the port in the references and readers."""

import json
import shutil
import subprocess
import sys

from benchmark import run as bench_run
from benchmark.manifest import ROOT

LOAD_ALL = """
import json, sys
import benchmark.run, benchmark.job, benchmark.check, benchmark.trace
import benchmark.sets, benchmark.control
from benchmark.manifest import Manifest
m = Manifest()
for x in m.bench["end_to_end"] + m.bench["per_layer"]:
    m.reader(x["name"])
for c in m.bench["configs"]:
    m.reference(c["name"])
print(json.dumps(sorted(sys.modules)))
"""

RUN_TINY = """
import json, sys
sys.path.insert(0, {tests!r})
from _tiny import TINY
from benchmark import job, run
from benchmark.manifest import Manifest
res, checks, rec = job.run(Manifest(), "glmm10k-chees", 3, 0.1, False,
                           device="cpu", log=lambda *a: None,
                           overrides=TINY["glmm10k-chees"])
print(json.dumps({{"bad": run.forbidden_modules(), "correct": res["correct"],
                  "port": "mamba_tpu_torch" in sys.modules}}))
"""


def _py(code, cwd=ROOT):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_harness_readers_and_references_load_no_jax_and_nothing_of_the_port():
    mods = _py(LOAD_ALL)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "mamba_tpu", "mamba_tpu_torch"}


def test_a_run_loads_the_port_and_neither_jax_nor_the_jax_package():
    out = _py(RUN_TINY.format(tests=str(ROOT / "benchmark" / "tests")))
    assert out == {"bad": [], "correct": True, "port": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("mamba_tpu_torch", "mamba_tpu_torch.ops", "jaxtyping",
                 "flaxen", "mamba_tpu_x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert bench_run.forbidden_modules() == []
    for name in ("mamba_tpu", "mamba_tpu.ops.random", "jax.numpy", "jaxlib",
                 "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert bench_run.forbidden_modules() == sorted(
        ["mamba_tpu", "mamba_tpu.ops.random", "jax.numpy", "jaxlib", "flax"])


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                            "rats-nuts", "--seed", "5", "--seconds", "1",
                            "--trace", "0"], cwd=cwd, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""
    # past the look for a card, a checkout without the port stops at its
    # import, before any result
    p = subprocess.run([sys.executable, "-c",
                        "from benchmark import job; from benchmark.manifest "
                        "import Manifest; job.run(Manifest(), 'rats-nuts', 1, "
                        "1.0, False, device='cpu')"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "mamba_tpu_torch" in p.stderr
