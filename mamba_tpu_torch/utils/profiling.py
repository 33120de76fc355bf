"""Profiling & tracing utilities.

Counterpart of the JAX package's ``utils/profiling.py`` (the reference has
no profiler at all, SURVEY.md §5): a ``torch.profiler`` trace written as a
Chrome trace (open it in Perfetto or ``chrome://tracing``), named spans that
show up in that trace and, on a CUDA device, as NVTX ranges, and timers
that synchronize the device so that queued kernels are inside the time.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "block_timer", "time_compiled", "annotate"]


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(logdir: str, host: bool = True):
    """Profile everything inside the block and write ``trace.json`` (a
    Chrome trace) under ``logdir``:

        with profiling.trace("runs/tr") as path:
            sim = mt.mcmc(model, inputs, inits, 100, chains=1024, device="cuda")

    The CUDA activity (kernels by name) is recorded when a CUDA device is
    present; ``host=True`` also records the host-side operators.  Yields
    the path of the trace file, which exists once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class annotate(contextlib.ContextDecorator):  # noqa: N801
    """Named sub-span inside a trace (``record_function``), and an NVTX range
    on a CUDA device: usable as decorator or context manager."""

    def __init__(self, name: str):
        self.name = name
        self._span = None

    def __enter__(self):
        self._span = torch.profiler.record_function(self.name)
        self._span.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_pop()
        self._span.__exit__(*exc)
        return False


@contextlib.contextmanager
def block_timer(label: str = "", sink: list | None = None):
    """Wall-clock a block, synchronizing the CUDA device at both ends (so
    asynchronous launches do not hide kernel time).  Appends (label,
    seconds) to ``sink`` when given, else prints."""
    if _cuda_in_use():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _cuda_in_use():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if sink is not None:
            sink.append((label, dt))
        else:
            print(f"[mamba_tpu_torch] {label or 'block'}: {dt:.4f}s")


def time_compiled(fn, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """Seconds per call of ``fn(*args, **kwargs)`` over ``iters`` warm calls.
    With a CUDA tensor among the arguments the time is taken by CUDA events
    around the calls (device time, launches included); otherwise by the
    host clock."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return (time.perf_counter() - t0) / iters
