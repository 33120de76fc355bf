"""How far a cut run lies inside its gates: the margins from which
``chip_smoke.py``'s depths and tolerances are chosen.

    python3 -m mamba_tpu_torch.scripts.gate_probe zoo pumps 280 250 --chains 64
    python3 -m mamba_tpu_torch.scripts.gate_probe recovery 150 75
    python3 -m mamba_tpu_torch.scripts.gate_probe smc-glmm --seeds 0 1 2 3 --steps 20
    python3 -m mamba_tpu_torch.scripts.gate_probe map-glmm --dtype float32
    python3 -m mamba_tpu_torch.scripts.gate_probe rats-nuts 12/6 16/8 --seeds 123 1

Run from the root of a checkout (the zoo gates are ``chip_smoke.py``'s
``ZOO_RUNS``/``ZOO_MV_RUNS``).  ``zoo`` runs one model at ITERS/BURNIN and
prints, per gated label, the mean, the golden mean, the tolerance and the
margin (tolerance - |mean - golden|; negative fails); ``recovery`` prints
the GLMM recovery run's largest beta error (gate 0.35); ``smc-glmm`` the
largest beta error of SMC on the G = 64 GLMM per seed; ``map-glmm`` the MAP
beta at G = 10,000 and its largest error against the truth; ``rats-nuts``
the rats NUTS headline at 1024 chains cut to each ITERS/BURNIN, per seed:
the kept mean of mu_beta, its margin on ``chip_smoke.py``'s gate
(``MU_BETA_TOL`` - |mean - ``MU_BETA``|) and the sampling seconds.  One JSON
line per run.  ``--device`` defaults to cuda.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

import numpy as np
import torch


def _zoo(args):
    import chip_smoke
    import mamba_tpu_torch as mt
    runs = {r[0]: r for r in chip_smoke.ZOO_RUNS + chip_smoke.ZOO_MV_RUNS
            if r[1] is None or r[0] == "seeds"}
    _, scheme, _, _, gates = runs[args.model]
    mod = importlib.import_module(f"mamba_tpu_torch.models.{args.model}")
    model, inputs, inits = mod.build() if scheme is None else mod.build(scheme)
    t0 = time.perf_counter()
    sim = mt.mcmc(model, inputs, inits, args.iters, burnin=args.burnin,
                  chains=args.chains, seed=args.seed, verbose=False,
                  device=args.device)
    s = mt.summarystats(sim).to_dict()
    out = {"model": args.model, "iters": args.iters, "burnin": args.burnin,
           "chains": args.chains, "seed": args.seed,
           "wall_s": time.perf_counter() - t0}
    for k, (golden, tol) in gates.items():
        mean = s[k]["Mean"]
        out[k] = {"mean": mean, "golden": golden, "tol": tol,
                  "margin": tol - abs(mean - golden)}
    print(json.dumps(out))


def _recovery(args):
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm
    model, inputs, inits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                             mass_window=50)
    sim = mt.mcmc(model, inputs, inits, args.iters, burnin=args.burnin,
                  chains=4, seed=args.seed, verbose=False, device=args.device)
    s = mt.summarystats(sim).to_dict()
    est = np.array([s[f"beta[{i + 1}]"]["Mean"] for i in range(4)])
    print(json.dumps({"iters": args.iters, "burnin": args.burnin,
                      "beta": est.tolist(),
                      "beta_err": float(np.abs(est - truth["beta"]).max())}))


def _smc_glmm(args):
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm
    for seed in args.seeds:
        model, inputs, inits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                                 mass_window=50)
        r = mt.smc(model, inputs, inits[0], n_particles=1024, seed=seed,
                   rejuvenation_steps=args.steps, device=args.device,
                   dtype=getattr(torch, args.dtype))
        b = r.particles["beta"].mean(0)
        print(json.dumps({"seed": seed, "steps": args.steps, "dtype": args.dtype,
                          "stages": r.n_stages, "beta": b.tolist(),
                          "beta_err": float(np.abs(b - truth["beta"]).max())}))


def _map_glmm(args):
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm
    model, inputs, inits, truth = glmm.build(G=10_000, fused=not args.generic)
    r = mt.optim_over(model, inputs, inits[0], device=args.device,
                      dtype=getattr(torch, args.dtype))
    print(json.dumps({"fused": not args.generic, "dtype": args.dtype,
                      "beta": r.params["beta"].tolist(),
                      "beta_err": float(np.abs(r.params["beta"]
                                               - truth["beta"]).max()),
                      "logpdf": r.logpdf, "niter": r.niter,
                      "converged": r.converged}))


def _rats_nuts(args):
    import chip_smoke
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import rats
    for cut in args.runs:
        iters, burnin = (int(v) for v in cut.split("/"))
        for seed in args.seeds:
            model, inputs, inits = rats.build("nuts")
            sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                          chains=args.chains, seed=seed, verbose=False,
                          device=args.device)
            mean = mt.summarystats(sim).to_dict()["mu_beta"]["Mean"]
            print(json.dumps({
                "iters": iters, "burnin": burnin, "chains": args.chains,
                "seed": seed, "mu_beta_mean": mean,
                "margin": chip_smoke.MU_BETA_TOL - abs(mean - chip_smoke.MU_BETA),
                "sample_s": sim.timing["sample_s"]}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    sub = p.add_subparsers(dest="what", required=True)
    z = sub.add_parser("zoo")
    z.add_argument("model")
    z.add_argument("iters", type=int)
    z.add_argument("burnin", type=int)
    z.add_argument("--chains", type=int, default=1024)
    z.add_argument("--seed", type=int, default=123)
    r = sub.add_parser("recovery")
    r.add_argument("iters", type=int)
    r.add_argument("burnin", type=int)
    r.add_argument("--seed", type=int, default=123)
    s = sub.add_parser("smc-glmm")
    s.add_argument("--seeds", type=int, nargs="+", default=[0])
    s.add_argument("--steps", type=int, default=10)
    s.add_argument("--dtype", default="float32")
    m = sub.add_parser("map-glmm")
    m.add_argument("--dtype", default="float32")
    m.add_argument("--generic", action="store_true")
    n = sub.add_parser("rats-nuts")
    n.add_argument("runs", nargs="+")
    n.add_argument("--seeds", type=int, nargs="+", default=[123])
    n.add_argument("--chains", type=int, default=1024)
    args = p.parse_args(argv)
    {"zoo": _zoo, "recovery": _recovery, "smc-glmm": _smc_glmm,
     "map-glmm": _map_glmm, "rats-nuts": _rats_nuts}[args.what](args)


if __name__ == "__main__":
    main()
