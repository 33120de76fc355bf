#!/usr/bin/env python3
"""What the length of a batch of shrink trips costs on the card: wall and
device time and host tests per iteration of some zoo models, for several
values of ``samplers.slice.TRIPS`` and ``samplers.slicesimplex.TRIPS``.

    python3 -m mamba_tpu_torch.scripts.trips_sweep

Run from the root of a checkout on a machine with a CUDA device.  For each
length of ``LENGTHS`` in turn, and each model of ``MODELS``: a run of 6
iterations (3 burnin) at 1024 chains, then ``zoo_probe``'s windows of 3
iterations (after its warm iterations, which capture the bodies a loop
needs now and then).
A longer batch needs fewer host tests but spends device time on trips that
no chain needs.  The samplers keep their own constant; the sweep sets it
in this process only.  It prints the card's name and power limit, then one
JSON line per length and model; results also go to
``build/lab/trips_sweep.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

#: the zoo models of the sweep: univariate Slice (pumps, magnesium),
#: both forms (inhalers), multivariate Slice (oxford) and SliceSimplex
#: (asthma, eyes)
MODELS = ("pumps", "magnesium", "inhalers", "oxford", "asthma", "eyes")
#: the batch lengths, set for both sampler families at once
LENGTHS = (8, 12, 16, 24)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    import torch
    from .. import mcmc
    from ..samplers import slice as slice_, slicesimplex
    from .zoo_probe import _device_ms, card
    report = {"card": card(torch, "cuda", "trips_sweep"), "rows": []}
    if report["card"] is None:
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(report["card"], flush=True)
    kept = slice_.TRIPS, slicesimplex.TRIPS
    try:
        for trips in LENGTHS:
            slice_.TRIPS = slicesimplex.TRIPS = trips
            for spec in MODELS:
                mod = importlib.import_module(f"mamba_tpu_torch.models.{spec}")
                model, inputs, inits = mod.build()
                sim = mcmc(model, inputs, inits, 6, burnin=3, chains=1024,
                           verbose=False, device="cuda")
                wall_ms, device_ms, events, counts = _device_ms(torch, sim, 3)
                row = {"trips": trips, "model": spec, "wall_ms_per_iter": wall_ms,
                       "device_ms_per_iter": device_ms,
                       "device_events_per_iter": events,
                       **{f"{k}_per_iter": v for k, v in counts.items()}}
                report["rows"].append(row)
                print(json.dumps(row), flush=True)
    finally:
        slice_.TRIPS, slicesimplex.TRIPS = kept
    out = Path("build") / "lab"
    out.mkdir(parents=True, exist_ok=True)
    (out / "trips_sweep.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
