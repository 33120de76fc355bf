"""How throughput scales with chains on one card, and with gloo ranks.

Counterpart of the JAX package's ``scripts/bench_scaling.py``, at its
depths; it prints its rows as JSON lines and writes no file.

- ``--mode chip``: the rats model at each chain count (1 to 4096) under
  NUTS (the over-dispersed inits, per-chain adaptation) and ChEES-HMC (one
  shared init, its contract), ``ITERS`` iterations of which ``BURNIN``
  warm up, each row in a process of its own under ``ROW_TIMEOUT``: a row
  that fails or runs out of time is recorded with its error and the sweep
  goes on.  A row holds samples/s and ESS/s (bulk ESS over ``sample_s``),
  the NUTS tree depth or ChEES's trajectory, and its speed-up over the
  sweep's first row that succeeded (named in ``speedup_base_chains``).
  ``--samplers`` and ``--chains`` cut the sweep to what a call can afford.
- ``--mode mesh``: the same NUTS run with ``PER_DEV_CHAINS`` chains per
  rank on 1, 2 and 4 gloo ranks on the CPU (one thread each), and the
  weak-scaling efficiency t_1 / t_n.  The ranks share the host's cores,
  and chains do not communicate, so this prices the port's per-rank
  overhead (start, collectives of the kept draws), not a card's scaling.

    python3 -m mamba_tpu_torch.scripts.bench_scaling --mode chip [--samplers nuts --chains 1,8]
    python3 -m mamba_tpu_torch.scripts.bench_scaling --mode mesh
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

#: the reference's sweep: 500 iterations of warmup, 350 kept (the rats
#: NUTS scheme's contract: its mass window refreshes at 100 and 300, and
#: chains from the over-dispersed second init converge in 150-300)
ITERS = 850
BURNIN = 500
CHAINS = (1, 8, 64, 256, 1024, 4096)
#: one row's limit, the reference's
ROW_TIMEOUT = 3000.0
#: the mesh mode's run per rank, the reference's: enough chains that the
#: fixed cost of each iteration does not read as lost efficiency
PER_DEV_CHAINS = 128
MESH_ITERS = 300
MESH_BURNIN = 100


def _build(sampler):
    from .. import samplers as S
    from ..models import rats
    model, inputs, inits = rats.build("nuts")
    if sampler == "chees":
        model.set_samplers([S.ChEESHMC(model.samplers[0].params,
                                       mass_window=50), *model.samplers[1:]])
        inits = [inits[0]]    # shared adaptation needs chains started together
    return model, inputs, inits


def run_row(sampler, chains, iters, burnin, device, mesh=None) -> dict:
    """One measured run (after a short run that warms the allocator)."""
    import mamba_tpu_torch as mt
    from ..samplers import nuts
    model, inputs, inits = _build(sampler)
    kw = dict(burnin=burnin, chains=chains, verbose=False, device=device,
              mesh=mesh)
    mt.mcmc(model, inputs, inits, 3, **dict(kw, burnin=1))
    depths = []
    inner = nuts.nuts_sub

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        depths.append(int(out[3].max()))
        return out

    nuts.nuts_sub = recording
    try:
        sim = mt.mcmc(model, inputs, inits, iters, **kw)
    finally:
        nuts.nuts_sub = inner
    dt = sim.timing["sample_s"]
    row = {"sampler": sampler, "chains": chains, "iters": iters,
           "burnin": burnin, "sample_s": dt,
           "samples_s": chains * iters / dt,
           "ess_s": float(np.sum(mt.ess_bulk(sim.value))) / dt}
    if sampler == "nuts":
        row["depth_max"] = max(depths) if depths else None
        row["leapfrogs_deepest"] = int(sum(2 ** d - 1 for d in depths))
    else:
        t = sim.states["tunes"][0]
        row["traj"] = float(t.traj)
        row["epsilonbar"] = float(t.epsilonbar)
    return row


def mode_chip(samplers=("nuts", "chees"), chains=CHAINS, iters=ITERS,
              burnin=BURNIN, device="cuda",
              row_timeout=ROW_TIMEOUT) -> list[dict]:
    rows = []
    for sampler in samplers:
        base = None
        for c in chains:
            cmd = [sys.executable, "-m", "mamba_tpu_torch.scripts.bench_scaling",
                   "--mode", "row", "--samplers", sampler, "--chains", str(c),
                   "--iters", str(iters), "--burnin", str(burnin),
                   "--device", device]
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=row_timeout)
                lines = [ln for ln in p.stdout.splitlines()
                         if ln.startswith("RESULT ")]
                row = (json.loads(lines[-1][len("RESULT "):]) if lines else
                       {"sampler": sampler, "chains": c,
                        "error": (p.stderr.strip().splitlines()
                                  or [f"exit {p.returncode}"])[-1][:300]})
            except subprocess.TimeoutExpired:
                row = {"sampler": sampler, "chains": c,
                       "error": f"timed out after {row_timeout} s"}
            if "samples_s" in row:
                if base is None:
                    base = row
                row["speedup_base_chains"] = base["chains"]
                row["speedup"] = row["samples_s"] / base["samples_s"]
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def _mesh_rank(args) -> None:
    """One rank of ``--mode mesh``: its NUTS run over the world's ranks."""
    import torch
    import torch.distributed as dist
    from ..parallel import distributed_init, make_mesh
    torch.set_num_threads(1)
    distributed_init(args.init, args.world, args.rank, device_type="cpu",
                     timeout=ROW_TIMEOUT)
    try:
        mesh = make_mesh({"chains": args.world}, "cpu")
        row = run_row("nuts", PER_DEV_CHAINS * args.world, MESH_ITERS,
                      MESH_BURNIN, "cpu", mesh=mesh)
        if args.rank == 0:
            print("RESULT " + json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()


def mode_mesh() -> dict:
    from ..parallel.launch import python_module, run_ranks
    out = {"per_rank_chains": PER_DEV_CHAINS, "iters": MESH_ITERS,
           "burnin": MESH_BURNIN, "cpu_cores": os.cpu_count(), "rows": []}
    for n in (1, 2, 4):
        t0 = time.perf_counter()
        stdout = run_ranks(lambda r, init: python_module(
            "mamba_tpu_torch.scripts.bench_scaling", "--mode", "mesh-rank",
            "--init", init, "--world", n, "--rank", r), n, timeout=ROW_TIMEOUT)
        row = json.loads([ln for ln in stdout[0].splitlines()
                          if ln.startswith("RESULT ")][-1][len("RESULT "):])
        row.update(ranks=n, wall_s=time.perf_counter() - t0)
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    t1 = out["rows"][0]["sample_s"]
    out["weak_scaling_efficiency"] = {r["ranks"]: t1 / r["sample_s"]
                                      for r in out["rows"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["chip", "mesh", "row", "mesh-rank"],
                    required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samplers", default="nuts,chees")
    ap.add_argument("--chains", default=",".join(map(str, CHAINS)))
    # set by the sweep for its rows, and by the mesh mode for its ranks
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--burnin", type=int, default=BURNIN)
    ap.add_argument("--init")
    ap.add_argument("--world", type=int)
    ap.add_argument("--rank", type=int)
    args = ap.parse_args(argv)
    if args.mode == "row":
        row = run_row(args.samplers, int(args.chains), args.iters, args.burnin,
                      args.device)
        print("RESULT " + json.dumps(row), flush=True)
        return 0
    if args.mode == "mesh-rank":
        _mesh_rank(args)
        return 0
    if args.mode == "chip":
        result = {"iters": ITERS, "burnin": BURNIN, "chain_sweep": mode_chip(
            args.samplers.split(","), [int(c) for c in args.chains.split(",")],
            device=args.device)}
        if args.device.startswith("cuda"):
            from .perf_profile import card
            result["card"] = card()
    else:
        result = {"gloo_weak_scaling": mode_mesh()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
