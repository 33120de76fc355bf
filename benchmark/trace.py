"""The traced run's profiled slice: a ``torch.profiler`` trace of one short
call, read in memory, and what the per-layer readers and the breakdown
take from it.

The trace is exported to a Chrome trace in a temporary directory under
``TMPDIR`` (the profiler has no stable in-memory form of the device's
events), loaded and deleted at once.  The slice is a restart of a few
iterations: its first iteration captures the samplers' graphs, so the span
read is from the end of the last capture to the end of the call.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import shutil
import tempfile
from collections import defaultdict

from benchmark.frozen.busy import busy_share, device_intervals, merged

SLICE = "benchmark.slice"
CAPTURE_CALLS = ("cudaStreamEndCapture", "cudaGraphInstantiate",
                 "cudaGraphInstantiateWithFlags")
GRAPH_LAUNCH = "cudaGraphLaunch"
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` (host and device activity);
    returns ``(fn's result, the trace's events)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    tmp = tempfile.mkdtemp(prefix="benchmark-trace-")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SLICE):
                out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, [e for e in events if e.get("ph") == "X" and "dur" in e]


class Slice:
    """The span of a profiled slice after its captures, its graph replays,
    and the device's busy time in it."""

    def __init__(self, events: list[dict]):
        self.events = events
        (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("name") == SLICE
                     and e.get("cat") == "user_annotation"] or [(None, None)]
        if lo is None:
            raise ValueError("the profiled slice's annotation is not in "
                             "the trace")
        runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
        captures = [e["ts"] + e["dur"] for e in runtime
                    if e.get("name") in CAPTURE_CALLS]
        launches = [e for e in runtime if e.get("name") == GRAPH_LAUNCH]
        if not (captures and launches):
            raise ValueError(
                "the profiled slice shows no graph "
                + ("capture (" + ", ".join(CAPTURE_CALLS) + ")"
                   if not captures else f"launch ({GRAPH_LAUNCH})")
                + ": the span after the captures and its replays are "
                "not defined")
        # the span after the last capture, and the replays launched in it
        self.lo = max(max(captures), lo)
        self.replays = sum(e["ts"] >= self.lo for e in launches)
        self.hi = hi
        share = busy_share(events, self.lo, self.hi)
        self.busy_s = 1e-3 * share["device_busy_ms"]
        self.window_s = 1e-6 * (self.hi - self.lo)
        self.device_events = share["device_events"]

    def kernel_calls(self, pattern: str) -> list[float]:
        """Device seconds of each call of a function whose kernels' names
        match ``pattern``: a call is a run of matching kernels with no
        other kernel between them, in the span."""
        rx = re.compile(pattern)
        kernels = sorted((e["ts"], e["dur"], e.get("name", ""))
                         for e in self.events if e.get("cat") == "kernel"
                         and self.lo <= e["ts"] < self.hi)
        calls, run = [], None
        for _, dur, name in kernels:
            if rx.search(name):
                run = (run or 0.0) + dur
            elif run is not None:
                calls.append(1e-6 * run)
                run = None
        if run is not None:
            calls.append(1e-6 * run)
        return calls

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the span, and its
        longest idle gaps by what the host was doing: ``[[name, seconds],
        ...]`` each, at most ``top`` entries."""
        ops = defaultdict(float)
        for a, b, name in ((max(e["ts"], self.lo),
                            min(e["ts"] + e["dur"], self.hi), e.get("name", ""))
                           for e in self.events if e.get("cat") in
                           ("kernel", "gpu_memcpy", "gpu_memset")
                           and e["ts"] < self.hi
                           and e["ts"] + e["dur"] > self.lo):
            ops[_short(name)] += 1e-6 * (b - a)
        busy = merged(device_intervals(self.events, self.lo, self.hi))
        edges = [self.lo] + [x for ab in busy for x in ab] + [self.hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", ""))
                      for e in self.events if e.get("cat") in HOST_CATS
                      and e.get("name") != SLICE)
        starts = [h[0] for h in host]
        idle = defaultdict(float)
        for a, b in gaps:
            idle[_host_at(host, starts, 0.5 * (a + b))] += 1e-6 * (b - a)
        pick = lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(ops), "idle_gaps": pick(idle)}


def _short(name: str, width: int = 96) -> str:
    """A kernel's name without its trailing argument list, at most ``width``
    long."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:width]


def _host_at(host, starts, t: float, look: int = 400) -> str:
    """The shortest host event running at ``t`` (the innermost), or
    "host: no traced op"."""
    i = bisect.bisect_right(starts, t)
    best = None
    for a, b, name in host[max(0, i - look):i]:
        if b >= t and (best is None or b - a < best[0]):
            best = (b - a, name)
    return _short(best[1]) if best else "host: no traced op"
