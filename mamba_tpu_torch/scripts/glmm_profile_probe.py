#!/usr/bin/env python3
"""Where the device time of a full-width GLMM gradient goes, on one CUDA card.

    python3 -m mamba_tpu_torch.scripts.glmm_profile_probe [--nuts-iters 1]

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit.  It sets up the two GLMM paths as ``chip_smoke.py`` does (G = 10,000,
n = 10, P = 4, 1024 chains, through the fused kernel):

- ChEES-HMC from an ADVI warm start, 20 iterations with 10 burnin, then 4
  more iterations unprofiled and 4 under ``torch.profiler``;
- NUTS, 10 iterations with 5 burnin, then ``--nuts-iters`` more unprofiled
  and as many under the profiler (0 skips the path).

For each window it prints the wall time, the fused kernel's launches (one
per gradient), and for the profiled window the device time summed over
CUDA-typed events, the device time per gradient, and the largest device
items by name with their share.  The profiler slows the host, so the wall
per gradient is taken from the unprofiled window, and the device's idle
share is one minus the profiled device time per gradient over it.  The
card's name and power limit are printed first.  Results also go to
``glmm_profile_probe.json`` in the ``--out`` directory (``build/lab`` unless
given).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

from .. import ChEESHMC, advi, mcmc
from ..models import glmm
from ..ops import fused_glmm as fg

CHAINS = 1024


def _window(torch, sim, iters, profiled):
    """Continue ``sim`` by ``iters`` iterations; returns the new chains and
    the window's measurements."""
    fg.glmm_loglik_grads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim = mcmc(sim, iters, verbose=False)
            torch.cuda.synchronize()
    else:
        sim = mcmc(sim, iters, verbose=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grads = fg.glmm_loglik_grads.launches
    out = {"iterations": iters, "wall_s": wall, "gradients": grads,
           "wall_ms_per_gradient": 1e3 * wall / grads}
    if profiled:
        by_name = defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name][0] += e.time_range.elapsed_us()
                by_name[e.name][1] += 1
        device_us = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        out.update(
            device_ms_per_gradient=1e-3 * device_us / grads,
            device_items=[{"name": k[:90], "share": v[0] / device_us,
                           "ms_per_gradient": 1e-3 * v[0] / grads,
                           "us_per_launch": v[0] / v[1], "launches": v[1]}
                          for k, v in top])
    return sim, out


def _probe(torch, name, sim, iters):
    res = {}
    for profiled in (False, True):
        sim, res["profiled" if profiled else "unprofiled"] = _window(
            torch, sim, iters, profiled)
    # the profiler slows the host, so idle is taken against the other window
    res["device_idle_share"] = 1 - (res["profiled"]["device_ms_per_gradient"]
                                    / res["unprofiled"]["wall_ms_per_gradient"])
    print(f"{name}: " + json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nuts-iters", type=int, default=1)
    ap.add_argument("--out", type=Path, default=fg.BUILD_DIR / "lab")
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("glmm_profile_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"card": card}

    # ChEES-HMC from ADVI, as chip_smoke.py's last phase sets it up
    model, inputs, inits, _ = glmm.build(10_000, fused=True)
    model_g, inputs_g, inits_g, _ = glmm.build(10_000, fused=False)
    fit = advi(model_g, inputs_g, inits_g[0], steps=1000, nmc=4, seed=1,
               device="cuda")
    from ..ops import random as R
    draws = {k: v.cpu().numpy()
             for k, v in fit.sample(R.key(5, "cuda"), CHAINS).items()}
    warm = [dict(inits[0], **{k: draws[k][i] for k in ("beta", "z", "s2")})
            for i in range(CHAINS)]
    model.set_samplers([ChEESHMC(model.samplers[0].params, max_steps=256,
                                 mass_window=40), *model.samplers[1:]])
    sim = mcmc(model, inputs, warm, 20, burnin=10, chains=CHAINS,
               verbose=False, device="cuda")
    report["glmm_chees"] = _probe(torch, "GLMM ChEES", sim, 4)
    del sim, warm, draws, fit

    if a.nuts_iters:
        model, inputs, inits, _ = glmm.build(10_000, n=10, seed=0, fused=True)
        sim = mcmc(model, inputs, inits, 10, burnin=5, chains=CHAINS,
                   verbose=False, device="cuda")
        report["glmm_nuts"] = _probe(torch, "GLMM NUTS", sim, a.nuts_iters)

    a.out.mkdir(parents=True, exist_ok=True)
    (a.out / "glmm_profile_probe.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
