"""The control of the output check, and the planted faults of the
samplers' transitions, at the final states of runs of a cell at its own
size.

The control is the plain reference put in the program's place and
computed in bfloat16, the nearest precision below the float32 that the
configurations state.  Each seed prints the program's numbers and the
control's, one JSON line each; with ``--fault`` the program runs with that
fault planted (``benchmark/faults.py``) and its numbers are the fault's
readings.  The benchmark's own runs do not run this:

    python3 -m benchmark.control --workload glmm10k-chees --seconds 5 \
        --seeds 11,12,13 [--fault always_accept] [--device cuda]

The limits in the traffic files lie above the program's readings and
below the control's or a fault's (``PERF.md`` gives them).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import check, faults, job
from benchmark.manifest import ROOT, Manifest


def readings(man, cell: str, seed: int, seconds: float, device: str,
             overrides=None, log=None, fault: str | None = None) -> dict:
    """The program's numbers, with ``fault`` planted, and the control's
    for one run of ``cell``."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    with faults.planted(fault):
        result, checks, rec = job.run(man, cell, seed, seconds, False,
                                      device=device, log=log,
                                      overrides=overrides)
    ref = man.reference(man.cell(cell)["config"])
    block = rec.traffic["check_chain_block"]
    ref64 = check.reference_side(ref, rec.data, rec.prog, torch.float64,
                                 device, block)
    ctrl = check.reference_side(ref, rec.data, rec.prog, torch.bfloat16,
                                device, block)
    control = check.gaps(*ctrl, ref64)
    return {"cell": cell, "seed": seed, "fault": fault,
            "correct": result["correct"],
            "program": {k: c["value"] for k, c in checks.items()},
            "control": control, "limits": rec.traffic["limits"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    man = Manifest(ROOT)
    for seed in a.seeds.split(","):
        print(json.dumps(readings(man, a.workload, int(seed), a.seconds,
                                  a.device, fault=a.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
