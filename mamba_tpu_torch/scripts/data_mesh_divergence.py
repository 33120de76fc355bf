"""Where line's run on a (1, 2) data mesh leaves the unsharded run, on the
CPU in float64: the run of ``tests/test_torch_multiproc.py``'s restart
test (line under NUTS + Slice, 4 chains, seed 3, y and xmat on the data
axis) on two gloo ranks and without a mesh, with beta, s2 and NUTS's step
size recorded after every block step.

    python -m mamba_tpu_torch.scripts.data_mesh_divergence [ITERS [BURNIN]]

Prints, per iteration, the largest relative difference of beta between
the two runs and its chain, and the first iteration where it passes 1e-8.
Slice's new s2 depends on beta only through its accept decisions, so s2
equal to the last bit means no decision flipped.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

SPECS = {"y": ("data",), "xmat": ("data", None)}


def _recorded(run):
    """``run()`` with every block step's beta, s2 and step size kept."""
    from ..model import mcmc as engine
    rec = []
    build = engine._build_kernels

    def recording(cm):
        out = []
        for k in build(cm):
            def step(key, state, tune, adapt, _inner=k.step):
                state, tune = _inner(key, state, tune, adapt)
                eps = getattr(tune, "epsilon", None)
                rec.append((state["beta"].clone().numpy(),
                            state["s2"].clone().numpy(),
                            np.nan if eps is None else float(eps.reshape(-1)[0])))
                return state, tune
            out.append(k._replace(step=step))
        return out

    engine._build_kernels = recording
    try:
        run()
    finally:
        engine._build_kernels = build
    return rec


def _run(iters, burnin, mesh=None):
    import mamba_tpu_torch as mt
    from ..models import line
    model, inputs, inits = line.build()
    return _recorded(lambda: mt.mcmc(
        model, inputs, inits, iters, burnin=burnin, chains=4, seed=3,
        mesh=mesh, site_specs=SPECS if mesh else None, device="cpu",
        verbose=False))


def _rank(init, rank, iters, burnin, out):
    import torch.distributed as dist
    from ..parallel import distributed_init
    from ..parallel.mesh import make_mesh
    torch.set_num_threads(1)
    distributed_init(init, 2, rank, device_type="cpu", timeout=60)
    try:
        rec = _run(iters, burnin, make_mesh({"chains": 1, "data": 2}, "cpu"))
        np.savez(Path(out) / f"rank{rank}.npz",
                 beta=np.stack([r[0] for r in rec]),
                 s2=np.stack([r[1] for r in rec]),
                 eps=np.array([r[2] for r in rec]))
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    if argv[:1] == ["--rank"]:
        _rank(argv[1], int(argv[2]), int(argv[3]), int(argv[4]), argv[5])
        return 0
    from ..parallel.launch import run_ranks
    iters = int(argv[0]) if argv else 100
    burnin = int(argv[1]) if len(argv) > 1 else 20
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="divergence-") as out:
        run_ranks(lambda r, init: [sys.executable, "-m", __spec__.name,
                                   "--rank", init, r, iters, burnin, out],
                  2, timeout=600, env=dict(os.environ))
        mesh = dict(np.load(Path(out) / "rank0.npz"))
    ref = _run(iters, burnin)
    blocks = len(ref) // iters
    first = None
    print(f"line, {iters} iterations, {burnin} burnin: iteration, largest "
          f"relative beta difference, its chain; s2 equal; step sizes' "
          f"relative difference")
    for it in range(iters):
        i = it * blocks                        # after NUTS, the first block
        beta, s2, eps = ref[i]
        d = np.abs(mesh["beta"][i] - beta) / np.abs(beta)
        same_s2 = bool(np.array_equal(mesh["s2"][i + 1], ref[i + 1][1]))
        deps = abs(mesh["eps"][i] - eps) / eps
        print(f"{it + 1} {d.max():.2e} chain {int(d.max(axis=1).argmax())} "
              f"s2 {'equal' if same_s2 else 'differs'} eps {deps:.0e}")
        if first is None and d.max() > 1e-8:
            first = it + 1
    print(f"first iteration past 1e-8: {first}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
