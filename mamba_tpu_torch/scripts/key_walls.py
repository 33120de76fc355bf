"""The walls of the two gradient arms that the keyed draws touch most, for a
before/after comparison of two checkouts on one card.

    python3 mamba_tpu_torch/scripts/key_walls.py [PACKAGE_ROOT]

Runs, with the ``mamba_tpu_torch`` found under ``PACKAGE_ROOT`` (default:
this checkout) and this checkout's ``chip_smoke.py``, that script's phase 6
(rats NUTS, ``RATS_NUTS_RUN`` at 1024 chains) and its GLMM ChEES arm at full
width (G = 10,000, 1024 chains) from the GLMM's own inits for ``CHEES_RUN``
(phase 10 starts from ADVI draws, whose API two checkouts may not share;
a leapfrog costs the same).  Prints the card and one JSON line of walls:
ms per leapfrog and seconds of sampling.  Run it on each checkout in turn
inside one call (parent, change, change, parent) to compare them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

#: the GLMM ChEES run: iterations, burnin
CHEES_RUN = (300, 100)


def main(argv) -> int:
    here = Path(__file__).resolve().parents[2]
    root = Path(argv[0]).resolve() if argv else here
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("key_walls: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", here / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm, rats
    from mamba_tpu_torch.ops import fused_glmm as fg
    from mamba_tpu_torch.samplers import chees, nuts
    if Path(mt.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {mt.__file__}, not the package at {root}")
    card = cs.phase_device(torch)
    fg.build_library()
    rats_res, _ = cs.phase_rats_nuts(torch, mt, rats, nuts)
    _, _, inits, _ = glmm.build(cs.MESH_G, fused=True)
    chees_res, _, _ = cs._glmm_chees_run(torch, mt, glmm, fg, chees, inits,
                                         "GLMM ChEES from its inits",
                                         run=CHEES_RUN)
    print(json.dumps({
        "root": str(root), "card": card,
        "rats_nuts": {k: rats_res[k] for k in (
            "sample_s", "leapfrog_steps", "wall_ms_per_leapfrog")},
        "glmm_chees": {k: chees_res[k] for k in (
            "sample_s", "leapfrog_steps", "wall_ms_per_leapfrog")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
