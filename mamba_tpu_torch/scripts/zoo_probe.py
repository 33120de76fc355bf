#!/usr/bin/env python3
"""What an iteration of each zoo model costs, and how far the host holds the
device back, at a given number of chains.

    python3 -m mamba_tpu_torch.scripts.zoo_probe [--models pumps,seeds]
        [--chains 1024] [--iters 30] [--burnin 10] [--profile-iters 2]
        [--device cuda] [--out build/lab]

Run from the root of a checkout.  For every model (all of the zoo unless
``--models`` names some; ``name:scheme`` picks a scheme, and by default
pollution runs each of its five) it runs the model's
own sampling scheme through ``mcmc`` and prints one JSON line: set-up and
sampling seconds, wall ms per iteration, chain-iterations per second, the
posterior means of the model's ``GOLDEN`` entries beside the golden values,
and the largest rank R-hat.  With ``--profile-iters`` it then continues the
run (one iteration first, to absorb first-use work such as a DGS block's
CUDA graph capture) by that many iterations unprofiled and as many under
``torch.profiler``: the device time summed over CUDA events per iteration,
the events (kernels, graph nodes included) per iteration, and the device's
idle share (one minus that over the unprofiled wall per iteration; the
profiler slows the host, so the wall is taken from the other window).  On a CUDA
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

#: models that take arguments of their own and are probed by chip_smoke.py
SKIP = ("glmm", "line", "rats")
#: every scheme of the models that offer several, probed one by one
SCHEMES = {"pollution": ("bhmc", "bmc3", "bmg", "dgs", "bia")}


def _device_ms(torch, sim, iters):
    """Unprofiled wall ms and profiled device ms and launches per iteration,
    over two windows of ``iters`` iterations that continue ``sim`` with one
    set of built kernels (a restart would build them again, and a DGS block
    would capture its CUDA graph again inside the window)."""
    from torch.profiler import ProfilerActivity, profile
    from ..model.mcmc import _build_kernels, _run
    cm, st = sim.compiled, sim.states
    kernels = _build_kernels(cm)
    gen = torch.Generator(device=cm.device)
    gen.set_state(st["rng"])
    state, tunes = st["state"], st["tunes"]

    def window(n):
        nonlocal state, tunes
        state, tunes, *_ = _run(cm, kernels, gen, state, tunes, 0, n, 1, None)

    window(1)                       # builds what the kernels build at first use
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window(iters)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(iters)
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall_ms, 1e-3 * device_us / iters, launches / iters


def probe(torch, spec, chains, iters, burnin, profile_iters, device, seed=123):
    name, _, scheme = spec.partition(":")
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
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
        wall_ms, dev_ms, launches = _device_ms(torch, sim, profile_iters)
        out.update(steady_wall_ms_per_iter=wall_ms, device_ms_per_iter=dev_ms,
                   device_launches_per_iter=launches,
                   device_idle_share=1 - dev_ms / wall_ms)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="")
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--burnin", type=int, default=10)
    ap.add_argument("--profile-iters", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=Path("build") / "lab")
    a = ap.parse_args(argv)

    import torch
    report = {}
    if torch.device(a.device).type == "cuda":
        if not torch.cuda.is_available():
            print("zoo_probe: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True
        ).stdout.strip().splitlines()[0]
        print(report["card"], flush=True)
    specs = ([m for m in a.models.split(",") if m] or
             [f"{m}:{sc}" if sc else m for m in ALL_MODELS if m not in SKIP
              for sc in SCHEMES.get(m, (None,))])
    report["models"] = [probe(torch, m, a.chains, a.iters, a.burnin,
                              a.profile_iters, a.device) for m in specs]
    a.out.mkdir(parents=True, exist_ok=True)
    (a.out / "zoo_probe.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
