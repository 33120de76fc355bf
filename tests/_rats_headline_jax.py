"""The JAX package's rats NUTS headline (``bench.py``: 1024 chains x 1500
iterations, 500 burnin, ``rats.build("nuts")``) on the CPU, with the
measures of ``mamba_tpu_torch/scripts/rats_headline.py``: bench.py's three
gates and the chains in transit, those whose mean of a monitored node lies
more than 10 within-chain standard deviations from the median chain mean.
A helper, not a test: it takes about 25 minutes on four cores.

    JAX_PLATFORMS=cpu python tests/_rats_headline_jax.py [seed]
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mamba_tpu as mt  # noqa: E402
from mamba_tpu.models import rats  # noqa: E402

TRANSIT_SDS = 10.0
#: bench.py's CHAINS, ITERS and BURNIN
CHAINS, ITERS, BURNIN = 1024, 1500, 500


def main(seed=123):
    model, inputs, inits = rats.build("nuts")
    t0 = time.time()
    sim = mt.mcmc(model, inputs, inits, ITERS, burnin=BURNIN, chains=CHAINS,
                  verbose=False, seed=seed)
    v = np.asarray(sim.value, dtype=np.float64)
    names = list(sim.names)
    means = v.mean(axis=0)
    z = (np.abs(means - np.median(means, axis=1, keepdims=True))
         / np.median(v.std(axis=0, ddof=1), axis=1, keepdims=True))
    far = np.where((z > TRANSIT_SDS).any(axis=0))[0]
    rhat = np.asarray(mt.rhat_rank(v))
    ess = np.asarray(mt.ess_bulk(v))
    print(json.dumps({
        "seed": seed, "chains": CHAINS, "iters": ITERS, "burnin": BURNIN,
        "seconds": time.time() - t0, "names": names,
        "means_float64": v.mean(axis=(0, 2)).tolist(),
        "rhat_rank": rhat.tolist(), "ess_bulk": ess.tolist(),
        "gates": {"golden mu_beta": bool(abs(v[:, names.index("mu_beta")].mean()
                                             - 6.1831) < 0.1),
                  "rank R-hat": bool(rhat.max() < 1.01),
                  "bulk ESS": bool(ess.min() > 400)},
        "in_transit": [{"chain": int(c), "sds_away": float(z[:, c].max()),
                        **{n: float(means[i, c]) for i, n in enumerate(names)}}
                       for c in far]}))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
