#!/usr/bin/env python3
"""The mesh phase of ``chip_smoke.py`` alone, run several times, for the
spread of its figures.

    python3 -m mamba_tpu_torch.scripts.mesh_probe

Run from the root of a checkout on a machine with a CUDA device; without
one it exits with status 2 and runs nothing.  It imports ``chip_smoke.py``
from the checkout's root and runs its phases in its order up to the mesh:
the card (its name and power limit, printed), the kernel's build, phase 10
(the GLMM ChEES run at full width from ADVI warm starts, which gives the
mesh phase its warm starts and its one-rank reference), then the mesh
phase (a)-(e) ``RUNS`` times, each with the same gates as in the script.
Printed per run: its wall, part (e)'s figures (``LOCAL {...}``: the
ranks' peak memory rise against the run without a mesh, the shapes each
rank's state holds, the block's all-reduce per density call, its shape
and ms, the wall per gradient, the density's device and eager ms per rank
and whole, the kernel's launches) and part (h)'s (``RATS {...}``: rats
NUTS on the data mesh, its wall per leapfrog and the shapes each rank
holds).  Everything also goes to ``build/lab/mesh_probe.json``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: times the mesh phase is run
RUNS = 2


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm
    from mamba_tpu_torch.ops import fused_glmm as fg
    from mamba_tpu_torch.samplers import chees
    from mamba_tpu_torch.scripts import glmm_cases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": cs.phase_device(torch)}
    cs.phase_build(fg)
    t0 = time.perf_counter()
    chees_res, warm, tunes = cs.phase_glmm_chees(torch, mt, glmm, fg, chees)
    out["glmm_chees_s"] = time.perf_counter() - t0
    out["glmm_chees_peak_rise_bytes"] = chees_res["peak_rise_bytes"]
    out["runs"] = []
    for k in range(RUNS):
        t0 = time.perf_counter()
        res = cs.phase_mesh(torch, mt, glmm, fg, chees, glmm_cases, warm, tunes)
        wall = time.perf_counter() - t0
        out["runs"].append({"mesh_s": wall, "local_views": res["local_views"],
                            "rats": res["rats"],
                            "kernel_ms": [c["ms"] for c in res["kernel"][:2]]})
        print(f"run {k}: mesh phase {wall:.1f} s", flush=True)
        print("LOCAL " + json.dumps(res["local_views"]), flush=True)
        print("RATS " + json.dumps(res["rats"]), flush=True)
    lab = ROOT / "build" / "lab"
    lab.mkdir(parents=True, exist_ok=True)
    (lab / "mesh_probe.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
