"""Roofline measurement: achieved FLOP/s and device-memory bytes/s of a
function against the card's published peaks.

Counterpart of the JAX package's ``utils/roofline.py``.  There XLA's cost
analysis counts a compiled program's FLOPs and bytes; PyTorch has no such
count, so here the caller states the work (``flops=``, ``bytes=``), counted
from the shapes as ``ops.fused_glmm.glmm_work`` counts it: each input read
once, each output written once.  Dividing by the measured time per call
gives the achieved rates and the share of each peak.

Peaks are the data sheets' for the cards this port runs on, keyed on
``torch.cuda.get_device_name``: "NVIDIA H100 80GB HBM3" is the SXM part,
whose float32 rate outside the tensor cores is 67 TFLOP/s; the PCIe part
(114 SMs, 2.0 TB/s) has lower peaks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Peaks(NamedTuple):
    """Published peaks of one card: float32 FLOP/s outside the tensor cores,
    dense bf16 tensor-core FLOP/s, device-memory bytes/s, streaming
    multiprocessors, and special-function (MUFU) results per clock per SM."""
    fp32_flops: float
    bf16_flops: float
    bytes_per_s: float
    sms: int
    sfu_per_clock_per_sm: int


H100_SXM = Peaks(fp32_flops=67e12, bf16_flops=989e12, bytes_per_s=3.35e12,
                 sms=132, sfu_per_clock_per_sm=16)
H100_PCIE = Peaks(fp32_flops=51e12, bf16_flops=756e12, bytes_per_s=2.0e12,
                  sms=114, sfu_per_clock_per_sm=16)

#: a part of the device's name -> its peaks; the first that matches wins
PEAKS = {
    "H100 80GB HBM3": H100_SXM,
    "H100 SXM": H100_SXM,
    "H100 PCIe": H100_PCIE,
}


def peaks_for(name: str) -> Peaks | None:
    """The peaks of the card called ``name``, or None for a card not in
    ``PEAKS``."""
    for k, v in PEAKS.items():
        if k.lower() in name.lower():
            return v
    return None


def device_peaks(name: str | None = None):
    """``(peak float32 FLOP/s, peak bytes/s)`` of the card called ``name``
    (default: CUDA device 0), or ``(None, None)`` for an unknown card."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    p = peaks_for(name)
    return (None, None) if p is None else (p.fp32_flops, p.bytes_per_s)


def elementwise_ceiling(n_elems: int = 64 * 1024 * 1024, iters: int = 20,
                        device="cuda") -> dict:
    """Measured ceiling of a float32 elementwise pass with a transcendental,
    ``exp(-|x|) + x`` over ``n_elems`` values (the counterpart of the JAX
    package's ``vpu_elementwise_ceiling``): seconds per call, elements/s,
    and the bytes/s it reached (one read and one write per element)."""
    from .profiling import time_compiled
    x = torch.ones(n_elems, dtype=torch.float32, device=device)
    s = time_compiled(lambda x: torch.exp(-torch.abs(x)) + x, x, iters=iters)
    return {"s_per_call": s, "elems": n_elems,
            "gelems_s": n_elems / s / 1e9, "gbytes_s": 8 * n_elems / s / 1e9}


def _tensors(tree):
    """The tensors of a tree of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def roofline(fn, *args, flops: float, bytes: float, iters: int = 20,
             warmup: int = 3, **kwargs) -> dict:
    """Time ``fn(*args, **kwargs)`` warm and report the achieved rates
    against the card's peaks for the stated work: ``flops`` float32
    operations and ``bytes`` moved per call.

    Returns keys: s_per_call, flops, bytes, gflops_s, gbytes_s, pct_flops,
    pct_hbm, bound_s (the larger of the two floors), bound ('memory' or
    'compute', the floor that sets bound_s; 'unknown' off a known card) and
    pct_of_bound."""
    from .profiling import time_compiled
    s = time_compiled(fn, *args, iters=iters, warmup=warmup, **kwargs)
    on_cuda = any(t.is_cuda for t in _tensors(args))
    peak_f, peak_b = device_peaks() if on_cuda else (None, None)
    res = {"s_per_call": s, "flops": float(flops), "bytes": float(bytes),
           "gflops_s": flops / s / 1e9, "gbytes_s": bytes / s / 1e9,
           "pct_flops": None, "pct_hbm": None, "bound_s": None,
           "bound": "unknown", "pct_of_bound": None}
    if peak_f is not None:
        floors = {"compute": flops / peak_f, "memory": bytes / peak_b}
        bound = max(floors, key=floors.get)
        res.update(pct_flops=100.0 * flops / s / peak_f,
                   pct_hbm=100.0 * bytes / s / peak_b,
                   bound_s=floors[bound], bound=bound,
                   pct_of_bound=100.0 * floors[bound] / s)
    return res
