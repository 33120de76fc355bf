"""Each metric's reader on a small synthetic run and event list."""

import math
from typing import NamedTuple

import pytest
import torch

from benchmark.frozen.glmm_work import glmm_bound_ms
from benchmark.job import Run
from benchmark.manifest import Manifest
from benchmark.trace import SLICE, Slice


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


def _events(with_runtime=True):
    ev = [_x(SLICE, "user_annotation", 0, 1000),
          _x("aten::add", "cpu_op", 20, 60),
          _x("void glmm_reg_kernel<4, 10>(float const*)", "kernel", 160, 40),
          _x("void glmm_finish_kernel(float const*)", "kernel", 200, 10),
          _x("void at::native::elementwise_kernel<128>(int)", "kernel", 220, 40),
          _x("void glmm_reg_kernel<4, 10>(float const*)", "kernel", 310, 40),
          _x("void glmm_finish_kernel(float const*)", "kernel", 350, 10),
          _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 900, 50),
          _x("aten::copy_", "cpu_op", 600, 250),
          # a kernel of the capture's warm-up, before the span
          _x("void glmm_reg_kernel<4, 10>(float const*)", "kernel", 30, 40)]
    if with_runtime:
        ev += [_x("cudaGraphInstantiate", "cuda_runtime", 80, 20),
               _x("cudaGraphLaunch", "cuda_runtime", 150, 5),
               _x("cudaGraphLaunch", "cuda_runtime", 300, 5),
               _x("cudaGraphLaunch", "cuda_runtime", 500, 5)]
    return ev


class _Tune(NamedTuple):
    """The fields of a ChEES tune that the leapfrog count reads."""
    it: int
    traj: torch.Tensor
    epsilonbar: torch.Tensor
    max_steps: int


#: 48 iterations after the warm-up, T / eps = 20.5: L = ceil(20.5 h)
TUNE = _Tune(it=348, traj=torch.tensor(0.41), epsilonbar=torch.tensor(0.02),
             max_steps=256)


def _run(slice_=None, **kw):
    man = Manifest()
    base = dict(cell={"name": "c"}, config={"G": 100, "n": 10, "P": 4},
                traffic={}, chains=8, iters=50,
                window_s=2.0, spans={"setup_s": 30.0, "warmup_s": 12.0},
                ess_min=40.0, ess_min_plain=30.0,
                reference=man.reference("glmm10k"),
                plain={"iters": 48, "seconds": 1.5,
                       "timing": {"capture_s": 0.25, "replays": 500},
                       "tunes": (TUNE,)},
                slice=slice_)
    base.update(kw)
    return Run(**base)


def read(name, run):
    return Manifest().reader(name).read(run)


def test_slice_reads_the_span_after_the_captures():
    s = Slice(_events())
    assert (s.lo, s.hi, s.replays) == (100.0, 1000.0, 3)
    assert s.busy_s == pytest.approx(190e-6)
    assert s.window_s == pytest.approx(900e-6)
    assert s.kernel_calls(r"\bglmm_\w+") == pytest.approx([50e-6, 50e-6])
    b = s.breakdown()
    assert b["device_ops"][0][0].endswith("glmm_reg_kernel<4, 10>")
    assert b["device_ops"][0][1] == pytest.approx(80e-6)
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(710e-6)
    assert dict(b["idle_gaps"])["aten::copy_"] == pytest.approx(540e-6)


@pytest.mark.parametrize("drop", [("cudaGraphInstantiate",),
                                  ("cudaGraphLaunch",)])
def test_a_slice_without_captures_or_launches_is_refused(drop):
    with pytest.raises(ValueError, match="no graph"):
        Slice([e for e in _events() if e["name"] not in drop])


def test_end_to_end_readers():
    run = _run()
    assert read("draws_per_s", run) == 8 * 50 / 2.0
    assert read("ess_per_s", run) == 20.0
    assert read("setup_s", run) == 30.0


def test_per_layer_readers():
    s = Slice(_events())
    run = _run(slice_=s)
    assert read("warmup_s", run) == 12.0
    assert read("advi_s", run) is None
    assert read("advi_s", _run(spans={"advi_s": 9.0})) == 9.0
    assert read("capture_s", run) == 0.25
    assert read("replays_per_draw", run) == 500 / 48
    assert read("ess_per_draw", run) == 40.0 / 400
    assert read("ess_per_s.window", run) == 30.0 / 1.5
    assert read("ms_per_replay", run) == pytest.approx(1e3 * 1.25 / 500)
    assert read("device_ms_per_replay", run) == pytest.approx(1e3 * 190e-6 / 3)
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - 190 / 900))
    bound = glmm_bound_ms(4, 10, 100, 8)["bound_ms"]
    assert read("fused_glmm_roofline", run) == pytest.approx(100 * bound / 0.05)
    flops = (4 * 4 + 12) * 8 * 10 * 100
    steps = sum(max(1, math.ceil(20.5 * sum(0.5 ** (k + 1) for k in range(16)
                                             if (i >> k) & 1)))
                for i in range(300, 348))
    assert read("mfu", run) == pytest.approx(100 * flops * steps / (1.5 * 67e12))


def test_readers_find_nothing_without_a_slice_or_counters():
    run = _run(plain={"iters": 48, "seconds": 1.5, "timing": {}, "tunes": ()})
    for name in ("capture_s", "replays_per_draw", "ms_per_replay",
                 "device_ms_per_replay", "device_idle_pct",
                 "fused_glmm_roofline", "mfu"):
        assert read(name, run) is None, name
    run = _run(slice_=Slice([e for e in _events() if "glmm" not in e["name"]]))
    assert read("fused_glmm_roofline", run) is None
    assert math.isfinite(read("device_idle_pct", run))
