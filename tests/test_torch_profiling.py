"""The port's profiling and roofline tools (tests/test_profiling.py's
timer, trace and span cases): timers that return positive times, a trace
written as a file, spans usable as context manager and decorator, the
H100 peaks keyed on the device name, and the fused GLMM kernel's bound
read from those peaks."""

import json

import pytest
import torch

from mamba_tpu_torch.ops import fused_glmm as fg
from mamba_tpu_torch.utils import profiling, roofline

torch.set_num_threads(2)


def test_block_timer_and_time_compiled():
    x = torch.ones(128)
    sink = []
    with profiling.block_timer("k", sink):
        (x * x).sum()
    assert sink and sink[0][0] == "k" and sink[0][1] > 0
    calls = []
    s = profiling.time_compiled(lambda v, k: calls.append(k) or v.sum(), x,
                                k=3, iters=3, warmup=1)
    assert s > 0 and calls == [3] * 4


def test_block_timer_prints_without_a_sink(capsys):
    with profiling.block_timer("span"):
        torch.zeros(4) + 1
    assert "[mamba_tpu_torch] span:" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as path:
        with profiling.annotate("inner_span"):
            torch.tanh(torch.ones(64)).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "inner_span" in names and "aten::tanh" in names


def test_annotate_context_and_decorator():
    with profiling.annotate("span"):
        torch.zeros(4) + 1

    @profiling.annotate("decorated")
    def f(x):
        return x + 1

    assert float(f(torch.zeros(()))) == 1.0


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (67e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (51e12, 2.0e12)),
    ("NVIDIA A100-SXM4-80GB", (None, None)),
    ("cpu", (None, None)),
])
def test_device_peaks(name, want):
    assert roofline.device_peaks(name) == want


def test_roofline_off_a_known_card_reports_no_share():
    x = torch.ones(1024)
    r = roofline.roofline(lambda v: v * 2.0, x, flops=1024, bytes=8192, iters=3)
    assert r["s_per_call"] > 0 and r["gbytes_s"] > 0
    assert r["bound"] == "unknown" and r["pct_of_bound"] is None


def test_elementwise_ceiling_runs_on_the_cpu():
    r = roofline.elementwise_ceiling(n_elems=1 << 16, iters=2, device="cpu")
    assert r["elems"] == 1 << 16 and r["s_per_call"] > 0
    assert r["gbytes_s"] == pytest.approx(8 * r["gelems_s"])


def test_glmm_bound_reads_the_roofline_peaks():
    """The bound at the bench's width and the card's top clock is the one
    PERF.md records: 0.0642 ms, set by float32 operations of the polynomial
    logarithm's form (42 per observation at 67 TFLOP/s)."""
    b = fg.glmm_bound_ms(4, 10, 10_000, 1024, 1.98e9)
    n_obs = 1024 * 10 * 10_000
    assert b["bound_by"] == "fp32"
    assert abs(b["bound_ms"] - 1e3 * 42 * n_obs / 67e12) < 1e-12
    assert abs(b["memory_ms"] - 1e3 * fg.glmm_work(4, 10, 10_000, 1024)["bytes"]
               / 3.35e12) < 1e-12
    assert abs(b["sfu_ms"] - 1e3 * 3 * n_obs / (132 * 16 * 1.98e9)) < 1e-12
    assert round(b["bound_ms"], 4) == 0.0642
    assert roofline.H100_SXM.fp32_flops == 67e12


def test_perf_profile_counts_the_work_of_a_call():
    """scripts/perf_profile.py's count: 2mnk for a matrix product, one per
    output element of a pointwise op, one per input element of a
    reduction, none for a view; bytes of the inputs and outputs once."""
    from mamba_tpu_torch.scripts.perf_profile import count_work
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    flops, nbytes = count_work(lambda a, b: torch.exp(a @ b).T.sum(), a, b)
    assert flops == 2 * 3 * 4 * 5 + 15 + 15
    assert nbytes == 4 * (12 + 20 + 1)
    # under torch.func's transforms too (the engine's vmap over chains)
    x = torch.ones(8, 6)
    flops, _ = count_work(torch.func.vmap(lambda v: (v * v).sum()), x)
    assert flops == 48 + 48


def test_bench_scaling_sweep_goes_on_past_a_failed_first_row(monkeypatch,
                                                             capsys):
    """A row that runs out of time is recorded and the sweep goes on; the
    speed-up is over the first row that succeeded (the JAX package's sweep
    keeps no base when its first row fails: ROADMAP Queue 3)."""
    import subprocess
    from types import SimpleNamespace
    from mamba_tpu_torch.scripts import bench_scaling

    def fake_run(cmd, **kw):
        chains = int(cmd[cmd.index("--chains") + 1])
        if chains == 1:
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        if chains == 8:
            return SimpleNamespace(stdout="", stderr="Traceback\nboom",
                                   returncode=1)
        row = {"sampler": "nuts", "chains": chains, "samples_s": 10.0 * chains}
        return SimpleNamespace(stdout="RESULT " + json.dumps(row), stderr="",
                               returncode=0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    rows = bench_scaling.mode_chip(["nuts"], [1, 8, 64, 256], iters=4,
                                   burnin=2, device="cpu", row_timeout=5.0)
    assert rows[0]["error"] == "timed out after 5.0 s"
    assert rows[1]["error"] == "boom"
    assert rows[2]["speedup"] == 1.0 and rows[3]["speedup"] == 4.0
    assert rows[3]["speedup_base_chains"] == 64
    assert len(capsys.readouterr().out.splitlines()) == 4


def test_bench_scaling_row_runs_rats_on_the_cpu():
    from mamba_tpu_torch.scripts.bench_scaling import run_row
    row = run_row("chees", 2, 4, 2, "cpu")
    assert row["chains"] == 2 and row["samples_s"] > 0 and row["traj"] > 0


@pytest.mark.parametrize("script, argv", [
    ("rats_headline", []), ("rats_headline", ["--device", "cpu"]),
    ("graph_probe", []), ("graph_probe", ["--device", "cpu"]),
    ("trips_sweep", []), ("zoo_probe", [])])
def test_card_scripts_refuse_to_run_without_a_cuda_device(script, argv,
                                                          monkeypatch, capsys):
    # a measurement that finds no card fails: it never samples on the CPU
    import importlib
    import mamba_tpu_torch
    mod = importlib.import_module(f"mamba_tpu_torch.scripts.{script}")
    sampled = []
    for owner in (mamba_tpu_torch, mod):
        if hasattr(owner, "mcmc"):
            monkeypatch.setattr(owner, "mcmc", lambda *a, **k: sampled.append(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(argv) == 2
    assert sampled == []
    assert "needs a CUDA device" in capsys.readouterr().err
