"""The rats ChEES arm's warm start (``bench.py:63-98``) on the CPU in
float32: ADVI for ``steps`` steps with ``nmc`` draws a step (seed 1), one
draw from q per chain (key 5), then ChEES-HMC with the conjugate Gibbs
block, 1024 chains x 1500 iterations, 500 burnin, at each mcmc seed given.
Prints q's means of the scalar nodes and, per seed, the rank R-hat, the
chains stuck in place (fewer than 5 distinct kept values of the first
monitored node) and the smallest final s2_beta.  A helper, not a test: a
seed takes about a minute (the JAX package) or three (the port) on four
cores.

    JAX_PLATFORMS=cpu python tests/_rats_chees_warm_start.py jax 1500 4 1 2 3
    JAX_PLATFORMS=cpu python tests/_rats_chees_warm_start.py port 5000 4 123

``port`` runs ``chip_smoke.py``'s phase 7 recipe (its ``_advi_warm_inits``)
on the CPU; with no seed it runs the mcmc default.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

CHAINS, ITERS, BURNIN = 1024, 1500, 500


def _stuck(v):
    return [c for c in range(v.shape[2]) if len(np.unique(v[:, 0, c])) < 5]


def _jax(steps, nmc, seeds):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import mamba_tpu as mt
    import mamba_tpu.samplers as S
    from mamba_tpu.infer import advi
    from mamba_tpu.models import rats
    model, inputs, inits = rats.build("nuts")
    model.set_samplers([S.ChEESHMC(model.samplers[0].params, mass_window=50),
                        *model.samplers[1:]])
    res = advi(model, inputs, inits[0], steps=steps, nmc=nmc, seed=1)
    print("q means", json.dumps({k: float(np.asarray(v).mean()) for k, v in
                                 res.mean_state().items() if np.ndim(v) == 0}))
    draws = {k: np.asarray(v)
             for k, v in res.sample(jax.random.key(5), CHAINS).items()}
    warm = [dict(inits[0], **{k: d[i] for k, d in draws.items()})
            for i in range(CHAINS)]
    for seed in seeds or [None]:
        kw = {} if seed is None else {"seed": seed}
        sim = mt.mcmc(model, inputs, warm, ITERS, burnin=BURNIN, chains=CHAINS,
                      verbose=False, **kw)
        v = np.asarray(sim.value)
        yield seed, v, float(np.min(np.asarray(sim.states["state"]["s2_beta"])))


def _port(steps, nmc, seeds):
    import torch
    import chip_smoke as cs
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import rats
    cs.DEVICE = "cpu"
    model, inputs, inits = rats.build("nuts")
    model = cs._chees_block(mt, model, mass_window=50)
    if nmc != 4:
        raise SystemExit("the port's recipe is chip_smoke.py's, nmc 4")
    warm, _ = cs._advi_warm_inits(torch, mt, model, inputs, inits[0], steps,
                                  CHAINS)
    for seed in seeds or [None]:
        kw = {} if seed is None else {"seed": seed}
        sim = mt.mcmc(model, inputs, warm, ITERS, burnin=BURNIN, chains=CHAINS,
                      verbose=False, device="cpu", dtype=torch.float32, **kw)
        v = np.asarray(sim.value)
        yield seed, v, float(sim.states["state"]["s2_beta"].min())


def main(argv):
    which, steps, nmc = argv[0], int(argv[1]), int(argv[2])
    seeds = [int(s) for s in argv[3:]]
    if which == "jax":
        import mamba_tpu as mt
        runs = _jax(steps, nmc, seeds)
    else:
        import mamba_tpu_torch as mt
        runs = _port(steps, nmc, seeds)
    for seed, v, s2_beta_min in runs:
        print(json.dumps({"package": which, "advi_steps": steps, "nmc": nmc,
                          "seed": seed,
                          "rhat_rank_max": float(np.max(mt.rhat_rank(v))),
                          "stuck": _stuck(v), "s2_beta_min": s2_beta_min}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
