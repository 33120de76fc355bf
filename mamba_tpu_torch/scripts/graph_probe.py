#!/usr/bin/env python3
"""What the engine's captured NUTS leaf costs on the card, against the plain
loop, for the rats NUTS headline at 1024 chains.

    python3 -m mamba_tpu_torch.scripts.graph_probe [--device cuda]

Run from the root of a checkout on a machine with a CUDA device; without
one it exits with status 2 and samples nothing.  It runs ``rats.build("nuts")`` for ``WARM`` iterations, then
times ``ITERS`` iterations from the run's end (its state, tunes and
chain keys) two ways, in the turns plain, graphed, graphed, plain:
the plain loop (``utils.graphs.disabled()``) and the engine's captured
leaf.  Each way builds its kernels, runs one iteration (so that the
capture is outside the window), and times the window from the same start,
so every window does the same leapfrogs and gives the same draws (held
equal).  Printed per way: wall ms per iteration and per leapfrog (the
deepest chain's ``2**depth - 1`` per iteration), the graphs and their
capture seconds; then, for the graphed leaf, the device busy share over a
window under ``torch.profiler`` (device time summed over its CUDA events
over the unprofiled wall of the same window).  On the card its name and
power limit are printed first; results also go to
``build/lab/graph_probe.json``.  Exit status 1 when the draws differ.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

#: chains, the warm run's iterations and burnin, the timed iterations
CHAINS, WARM, WARM_BURNIN, ITERS = 1024, 30, 15, 4


def _window(torch, sim, graphed, depths):
    """``ITERS`` iterations from ``sim``'s end with freshly built kernels,
    with the captured leaf or the plain loop.  Returns the kept draws, the
    wall seconds of the timed window, the graph counts and the run."""
    from ..model.mcmc import _build_kernels, _run
    from ..utils import graphs
    cm, st = sim.compiled, sim.states
    with contextlib.nullcontext() if graphed else graphs.disabled():
        kernels = _build_kernels(cm)
    stats0 = dict(graphs.STATS)

    def run(n):
        return _run(cm, kernels, st["key"], st["state"], st["tunes"], 0, n, 1,
                    None)

    run(1)                          # captures, outside the window
    del depths[:]
    out = run(ITERS)
    return (out[3], out[4]["sample_s"],
            {k: graphs.STATS[k] - stats0[k] for k in stats0}, run)


def _busy_share(torch, run, iters):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(iters)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(iters)
        torch.cuda.synchronize()
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = 1e-6 * sum(e.time_range.elapsed_us() for e in cuda)
    return {"wall_s": wall, "device_s": device_s, "events": len(cuda),
            "device_busy_share": device_s / wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch
    from .. import mcmc
    from ..models import rats
    from ..samplers import nuts
    from .zoo_probe import card
    report = {"card": card(torch, a.device, "graph_probe")}
    if report["card"] is None:
        return 2
    print(report["card"], flush=True)
    model, inputs, inits = rats.build("nuts")
    sim = mcmc(model, inputs, inits, WARM, burnin=WARM_BURNIN, chains=CHAINS,
               verbose=False, device=a.device)
    report["warm"] = {"iters": WARM, "burnin": WARM_BURNIN, **sim.timing}
    depths = []
    inner = nuts.nuts_sub

    def recording(*args, **kw):
        out = inner(*args, **kw)
        depths.append(out[3].detach().cpu())
        return out

    nuts.nuts_sub = recording
    rows, draws, runs = {"plain": [], "graphed": []}, {}, {}
    try:
        for way in ("plain", "graphed", "graphed", "plain"):
            value, wall, stats, run = _window(torch, sim, way == "graphed",
                                              depths)
            d = torch.stack(depths)
            leapfrogs = int((2 ** d.max(dim=1).values.long() - 1).sum())
            rows[way].append({"wall_s": wall, "leapfrogs": leapfrogs,
                              "ms_per_iter": 1e3 * wall / ITERS,
                              "ms_per_leapfrog": 1e3 * wall / leapfrogs,
                              "max_depth": d.max(dim=1).values.tolist(),
                              **stats})
            draws.setdefault(way, value)
            runs[way] = run
            print(json.dumps({"way": way, **rows[way][-1]}), flush=True)
    finally:
        nuts.nuts_sub = inner
    report["ways"] = rows
    report["draws_equal"] = np.array_equal(draws["plain"], draws["graphed"])
    report["busy_graphed"] = _busy_share(torch, runs["graphed"], 2)
    print(json.dumps({k: report[k] for k in report if k != "ways"}), flush=True)
    out = Path("build") / "lab"
    out.mkdir(parents=True, exist_ok=True)
    (out / "graph_probe.json").write_text(json.dumps(report, indent=1))
    return 0 if report["draws_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
