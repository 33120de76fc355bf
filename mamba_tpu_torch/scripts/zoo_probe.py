#!/usr/bin/env python3
"""What an iteration of each zoo model costs, and how far the host holds the
device back, at a given number of chains.

    python3 -m mamba_tpu_torch.scripts.zoo_probe [--models pumps,seeds]
        [--chains 1024] [--iters 30] [--burnin 10] [--profile-iters 2]
        [--block-iters 3] [--device cuda] [--out build/lab]

Run from the root of a checkout.  For every model (all of the zoo but
``SKIP`` unless ``--models`` names some, which may name those too:
``rats:nuts`` is the bench's headline scheme, ``glmm:centered`` the centered
GLMM through the fused kernel at the bench's width, NUTS with a conjugate
Gibbs block; ``name:scheme`` picks a scheme, and by default pollution runs
each of its five) it runs the model's
own sampling scheme through ``mcmc`` and prints one JSON line: set-up and
sampling seconds, wall ms per iteration, chain-iterations per second, the
posterior means of the model's ``GOLDEN`` entries beside the golden values,
and the largest rank R-hat.  With ``--profile-iters`` it then continues the
run twice, with the engine's captured steps and with the samplers' plain
loops (``utils.graphs.disabled()``), each with kernels of its own: three
iterations first (to absorb first-use work such as the captures), that many
iterations unprofiled and as many under ``torch.profiler``.  Per way it
reports the wall ms per iteration (unprofiled), the device time summed
over CUDA events per iteration, the events (kernels, graph nodes
included) per iteration, the device's busy share (device time over the
unprofiled wall; the profiler slows the host, so the wall is taken from
the other window), and the graphs, replays and host tests per iteration.
A last window of the captured way records every loop of trip batches
(``graphs.until_done``): per sampler form, the deepest chain's trips per
coordinate (or row, or trajectory) and the batches each took.  On a CUDA
device the card's name and power limit are printed first.  Results also go
to ``zoo_probe.json`` in the ``--out`` directory.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .. import mcmc, rhat_rank, summarystats
from ..models import __all__ as ALL_MODELS

#: models that take arguments of their own and are probed by chip_smoke.py;
#: left out of the default list only
SKIP = ("glmm", "line", "rats")
#: iterations that continue a run before its timed windows
WARM = 3
#: every scheme of the models that offer several, probed one by one
SCHEMES = {"pollution": ("bhmc", "bmc3", "bmg", "dgs", "bia")}


def card(torch, device, prog):
    """The card's name and power limit (``nvidia-smi``) for a run on the
    CUDA device ``device``, or None, with a message on standard error, when
    ``device`` is not one or no CUDA device is present."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        print(f"{prog}: needs a CUDA device (asked for {device!r}; CUDA "
              f"available: {torch.cuda.is_available()})", file=sys.stderr)
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def _device_ms(torch, sim, iters, plain=False, trips=False):
    """Unprofiled wall ms and profiled device ms and launches per iteration,
    over two windows of ``iters`` iterations that continue ``sim`` with one
    set of built kernels (a restart would build them again, and every
    captured step would be captured again inside the window): the captured
    steps, or with ``plain`` the plain loops.  Also returns the graph
    counters per iteration over the unprofiled window, and with ``trips``
    the trip batches of one more window (``_trip_window``)."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from ..model.mcmc import _build_kernels, _run
    from ..utils import graphs
    cm, st = sim.compiled, sim.states
    with graphs.disabled() if plain else contextlib.nullcontext():
        kernels = _build_kernels(cm)
    keys, state, tunes = st["key"], st["state"], st["tunes"]

    def window(n):
        nonlocal keys, state, tunes
        keys, state, tunes, *_ = _run(cm, kernels, keys, state, tunes, 0, n, 1,
                                      None)

    # builds what the kernels build at first use, and captures the bodies a
    # loop of trips needs only now and then (a second batch)
    window(WARM)
    torch.cuda.synchronize()
    stats0 = dict(graphs.STATS)
    t0 = time.perf_counter()
    window(iters)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    counts = {k: (graphs.STATS[k] - stats0[k]) / iters
              for k in ("graphs", "replays", "host_tests")}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(iters)
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    out = (wall_ms, 1e-3 * device_us / iters, launches / iters, counts)
    if trips:
        out += (_trip_window(graphs, lambda: window(iters)),)
    return out


def _form(bufs):
    """The sampler form whose trip batches ``bufs`` hold."""
    if "Tsim0" in bufs:
        return "ABC"
    if "hits" in bufs:
        return "BHMC"
    if "row" in bufs:
        return "SliceSimplex"
    return "Slice univariate" if "i" in bufs else "Slice multivariate"


def _trip_window(graphs, run):
    """``run()`` with every ``graphs.until_done`` recorded: per sampler form,
    the deepest chain's trips in each loop (a coordinate, a row, a
    trajectory: a host read after the loop, outside any timing; for ABC,
    the batches of draws) and the batches it took, summarized."""
    seen = {}
    inner = graphs.until_done

    def recording(cap, *args, **kwargs):
        runs = inner(cap, *args, **kwargs)
        b = cap.bufs
        # ABC's draws come in batches of a fixed size: its loop's length is
        # the batches it took
        deepest = (runs if "Tsim0" in b
                   else int((b["hits"] - b["hits0"]).max()) if "hits" in b
                   else int(b["trips"].max()))
        seen.setdefault(_form(b), []).append((deepest, runs))
        return runs

    graphs.until_done = recording
    try:
        run()
    finally:
        graphs.until_done = inner
    out = {}
    for form, rows in seen.items():
        deep = np.array([r[0] for r in rows])
        runs = np.array([r[1] for r in rows])
        out[form] = {"loops": len(rows),
                     "deepest_trips": dict(zip(
                         ("50%", "90%", "99%", "max"),
                         np.quantile(deep, [.5, .9, .99, 1.0]).tolist())),
                     "batches_mean": float(runs.mean()),
                     "batches_max": int(runs.max()),
                     "one_batch_share": float((runs == 1).mean())}
    return out


def _block_ms(torch, sim, iters):
    """Wall ms per iteration of each block's step over ``iters`` iterations
    that continue ``sim`` (after ``WARM`` more), the device synchronized
    before and after every step, and each block's share of their sum."""
    from ..model.mcmc import _build_kernels, _sync
    cm, st = sim.compiled, sim.states
    kernels = _build_kernels(cm)
    from ..ops import random as R
    keys, state, tunes = st["key"], st["state"], list(st["tunes"])
    ms = [0.0] * len(kernels)
    for it in range(WARM + iters):
        for j, k in enumerate(kernels):
            keys, sub = R.split(keys)
            _sync(cm.device)
            t0 = time.perf_counter()
            state, tunes[j] = k.step(sub, state, tunes[j], False)
            _sync(cm.device)
            if it >= WARM:
                ms[j] += 1e3 * (time.perf_counter() - t0) / iters
    labels = [repr(s) for s in cm.model.samplers]
    return {"block_ms_per_iter": dict(zip(labels, ms)),
            "block_share": dict(zip(labels, (m / sum(ms) for m in ms)))}


def probe(torch, spec, chains, iters, burnin, profile_iters, device, seed=123,
          block_iters=0):
    name, _, scheme = spec.partition(":")
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    if name == "glmm":
        model, inputs, inits, _ = mod.build(fused=True,
                                            centered=scheme == "centered")
    else:
        model, inputs, inits = mod.build(scheme) if scheme else mod.build()
    sim = mcmc(model, inputs, inits, iters, burnin=burnin, chains=chains,
               verbose=False, device=device, seed=seed)
    s = summarystats(sim).to_dict()
    golden = getattr(mod, "GOLDEN", {})
    out = {"model": spec, "chains": chains, "iters": iters, "burnin": burnin,
           "blocks": [repr(b) for b in model.samplers],
           "setup_s": sim.timing["setup_s"], "sample_s": sim.timing["sample_s"],
           "ms_per_iter": 1e3 * sim.timing["sample_s"] / iters,
           "chain_iters_per_s": chains * iters / sim.timing["sample_s"],
           "means": {k: s[k]["Mean"] for k in golden},
           "golden": {k: v["Mean"] for k, v in golden.items()},
           "finite": bool(np.isfinite(sim.value).all()),
           "rhat_rank_max": float(np.max(rhat_rank(sim.value)))}
    if profile_iters and torch.device(device).type == "cuda":
        for way in ("captured", "plain"):
            got = _device_ms(torch, sim, profile_iters, plain=way == "plain",
                             trips=way == "captured")
            wall_ms, dev_ms, launches, counts = got[:4]
            out[way] = {"wall_ms_per_iter": wall_ms, "device_ms_per_iter": dev_ms,
                        "device_launches_per_iter": launches,
                        "device_busy_share": dev_ms / wall_ms,
                        **{f"{k}_per_iter": v for k, v in counts.items()}}
            if way == "captured":
                out["trips"] = got[4]
    if block_iters:
        out.update(_block_ms(torch, sim, block_iters))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="")
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--burnin", type=int, default=10)
    ap.add_argument("--profile-iters", type=int, default=0)
    ap.add_argument("--block-iters", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("build") / "lab")
    a = ap.parse_args(argv)

    import torch
    report = {}
    if torch.device(a.device).type == "cuda":
        report["card"] = card(torch, a.device, "zoo_probe")
        if report["card"] is None:
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        print(report["card"], flush=True)
    specs = ([m for m in a.models.split(",") if m] or
             [f"{m}:{sc}" if sc else m for m in ALL_MODELS if m not in SKIP
              for sc in SCHEMES.get(m, (None,))])
    report["models"] = [probe(torch, m, a.chains, a.iters, a.burnin,
                              a.profile_iters, a.device,
                              block_iters=a.block_iters) for m in specs]
    a.out.mkdir(parents=True, exist_ok=True)
    (a.out / "zoo_probe.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
