#!/usr/bin/env python3
"""The JAX package's ``bench.py`` headline on the port: rats NUTS
(``rats.build("nuts")``: NUTS with diagonal mass adaptation on the 62
effects, conjugate Gibbs on the 3 variances), 1024 chains x 1500 iterations
of which 500 warm up, held to bench.py's three gates (bench.py:46-52,
271-272): the golden mean of mu_beta within 0.1 of 6.1831, rank R-hat
< 1.01 and bulk ESS > 400.

    python3 -m mamba_tpu_torch.scripts.rats_headline [--seed 123] [--device cuda]

Run from the root of a checkout on a machine with a CUDA device; without
one it exits with status 2 and samples nothing.  ``--seed`` is ``mcmc``'s seed, 123 by default; PERF.md reports
the gates at seeds 123, 1 and 2.  It prints the card's name and power
limit, then one JSON line: ``sample_s``, the leapfrogs (the deepest
chain's ``2**depth - 1`` per iteration, what the lockstep chains pay),
wall ms per leapfrog, chain-iterations per second, the CUDA graphs and
their capture seconds, ESS/s (``summarystats``' bulk ESS over
``sample_s``, summed over the monitored nodes and the least), the gates'
values and verdicts.  A gate can fail on a few chains that are still far
from the posterior when warmup ends, so it also prints, per monitored
node, the quantiles of the chain means and the chains in transit: those
whose mean lies more than ``TRANSIT_SDS`` within-chain standard deviations
(the median over chains) from the median chain mean, with their final
step sizes.  Then the device's busy share over two more iterations
(``zoo_probe``'s measure).  The draws go to ``build/lab/rats_headline.npz``.
Exit status 1 when a gate fails, as bench.py's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

#: the headline run: bench.py's CHAINS, ITERS and BURNIN (bench.py:39-46)
CHAINS, ITERS, BURNIN = 1024, 1500, 500
#: bench.py:46-52 and the golden mu_beta (doc/examples/rats.rst:42-47)
RHAT_MAX, ESS_MIN, MU_BETA, MU_BETA_TOL = 1.01, 400.0, 6.1831, 0.1
#: a chain whose mean lies this many within-chain SDs from the others'
TRANSIT_SDS = 10.0


def transit(value, names, eps):
    """Per monitored node the quantiles of the chain means, and the chains
    in transit with their distance in within-chain SDs and step size."""
    means = value.mean(axis=0)                        # (nodes, chains)
    sds = value.std(axis=0, ddof=1)
    centre = np.median(means, axis=1, keepdims=True)
    z = np.abs(means - centre) / np.median(sds, axis=1, keepdims=True)
    far = np.where((z > TRANSIT_SDS).any(axis=0))[0]
    return {"chain_mean_quantiles": {
                n: dict(zip(("min", "1%", "50%", "99%", "max"),
                            np.quantile(means[i], [0, .01, .5, .99, 1]).tolist()))
                for i, n in enumerate(names)},
            "in_transit": [{"chain": int(c), "eps": float(eps[c]),
                            **{n: float(means[i, c]) for i, n in enumerate(names)},
                            "sds_away": float(z[:, c].max())} for c in far]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    seed = a.seed

    import torch
    from .. import ess_bulk, mcmc, rhat_rank, summarystats
    from ..models import rats
    from ..samplers import nuts
    from .zoo_probe import _device_ms, card
    name = card(torch, a.device, "rats_headline")
    if name is None:
        return 2
    print(name, flush=True)
    model, inputs, inits = rats.build("nuts")
    depths = []
    inner = nuts.nuts_sub

    def recording(*args, **kw):
        out = inner(*args, **kw)
        depths.append(out[3].detach().cpu())
        return out

    nuts.nuts_sub = recording
    try:
        sim = mcmc(model, inputs, inits, ITERS, burnin=BURNIN, chains=CHAINS,
                   seed=seed, verbose=False, device=a.device)
    finally:
        nuts.nuts_sub = inner
    v = sim.value
    t = sim.timing
    d = torch.stack(depths)
    leapfrogs = int((2 ** d.max(dim=1).values.long() - 1).sum())
    s = summarystats(sim).to_dict()
    ess_s = np.array([s[n]["ESS"] for n in sim.names]) / t["sample_s"]
    rhat = float(np.max(rhat_rank(v)))
    ess = float(np.min(ess_bulk(v)))
    gates = {"golden mu_beta": abs(s["mu_beta"]["Mean"] - MU_BETA) < MU_BETA_TOL,
             "rank R-hat": rhat < RHAT_MAX, "bulk ESS": ess > ESS_MIN}
    res = {"seed": seed, "chains": CHAINS, "iters": ITERS,
           "burnin": BURNIN, "sample_s": t["sample_s"],
           "setup_s": t["setup_s"], "leapfrogs": leapfrogs,
           "wall_ms_per_leapfrog": 1e3 * t["sample_s"] / leapfrogs,
           "chain_iters_per_s": CHAINS * ITERS / t["sample_s"],
           "graphs": t.get("graphs", 0), "capture_s": t.get("capture_s", 0.0),
           "mean_tree_depth": float(d.float().mean()),
           "ess_per_s_total": float(ess_s.sum()),
           "ess_per_s_min": float(ess_s.min()),
           "means": {n: s[n]["Mean"] for n in sim.names},
           "rhat_rank": np.asarray(rhat_rank(v)).tolist(),
           "ess_bulk": np.asarray(ess_bulk(v)).tolist(),
           "gates": gates,
           **transit(v, sim.names, sim.states["tunes"][0].epsilon.cpu().numpy())}
    wall_ms, device_ms, events, _ = _device_ms(torch, sim, 2)
    res["busy"] = {"wall_ms_per_iteration": wall_ms,
                   "device_ms_per_iteration": device_ms,
                   "device_events_per_iteration": events,
                   "device_busy_share": device_ms / wall_ms}
    print(json.dumps(res), flush=True)
    out = Path("build") / "lab"
    out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out / "rats_headline.npz", value=v,
                        depth=d.numpy().astype(np.int8))
    return 0 if all(gates.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
