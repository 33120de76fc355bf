"""The device's busy share over a span of a Chrome trace.

Frozen copy of ``chip_smoke.py``'s ``_busy_share`` at commit
fc13fd826c36831480dadd26fb8e0f34af6cabfa: the union of the kernel, copy
and fill intervals (graph replays' kernels included) clipped to the span,
over the span's length.  The copy takes the span's bounds ``lo``, ``hi``
(microseconds) instead of the name of a host annotation, and also returns
the merged intervals, which the breakdown's idle gaps are read from.
"""

from __future__ import annotations

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(events, lo: float, hi: float) -> list[tuple[float, float]]:
    """The device's events that overlap ``[lo, hi]``, clipped to it,
    sorted by start."""
    return sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS
                  and e["ts"] < hi and e["ts"] + e["dur"] > lo)


def merged(spans) -> list[tuple[float, float]]:
    """The union of sorted intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_share(events, lo: float, hi: float) -> dict:
    """``span_ms``, ``device_busy_ms``, ``device_events`` and
    ``device_busy_share`` of the span ``[lo, hi]``."""
    spans = device_intervals(events, lo, hi)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"span_ms": 1e-3 * (hi - lo), "device_busy_ms": 1e-3 * busy,
            "device_events": len(spans), "device_busy_share": busy / (hi - lo)}
