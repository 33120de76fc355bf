#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit.  It drives every arm of the JAX package's ``bench.py``, fifteen
runs of the model zoo, the output layer, MAP, SMC and the profiling tools
through the port's public entry points (``mcmc``, ``advi``,
``summarystats``, ``rhat_rank``, ``ess_bulk``, ``forward_sample``,
``gelmandiag``, ``dic``, ``predict``, ``write_chains``/``read_chains``,
``plot``/``draw``, ``optim_over``, ``smc``, ``utils.profiling``,
``utils.roofline``), in these phases:

1. device: the card's name, power limit and SM clocks;
2. build: ``mamba_tpu_torch/csrc/fused_glmm.cu`` with nvcc (sm_90a);
3. kernel: the fused GLMM kernel against its plain torch version in five
   cases (``KERNEL_CASES``): full width, where both are timed; a ragged
   edge; one chain; a shape that takes the generic kernel; and full width
   near a posterior mode, where ``grad_beta`` cancels;
4. GLMM recovery: ``glmm.build(G=64, fused=True)`` under NUTS, 4 chains,
   ``z`` monitored for the post phase;
5. GLMM NUTS at full width: G = 10,000, 1024 chains, a short run;
6. rats NUTS, the bench's headline: ``rats.build("nuts")``, 1024 chains,
   cut from 1500 to 30 iterations (15 burnin), gated on the golden
   mu_beta mean (rank R-hat and bulk ESS printed; they are gated only for
   runs of 500 kept draws or more);
7. rats ChEES: ADVI warm start, then ChEES-HMC with the conjugate Gibbs
   block, 1024 chains x 1500 iterations (500 burnin), gated on the golden
   mu_beta mean, rank R-hat < 1.01 and bulk ESS > 400;
8. zoo: pumps, surgical, seeds (its reference scheme) and mice (NaN inits,
   MISS) with the schemes their ``build()`` gives, 1024 chains each, gated
   on the golden means of the JAX package's golden tests with those tests'
   tolerances (``ZOO_RUNS``), on finite draws, and on no draw having come
   from the global generator;
9. zoo_mv, the multivariate half of the zoo (``ZOO_MV_RUNS``), 1024 chains
   each: eyes (DGS on 48 indicators, its sweep replayed from a CUDA graph
   and held equal to the eager sweep; SliceSimplex), jaws (BDiagNormal,
   InverseWishart under AMWG) and line_abc (ABC) under the golden gates of
   the JAX package's tests; pollution under each of its five binary
   schemes (DGS gated on gamma[9] > 0.8 and gamma[2] < 0.6, BHMC's wall
   hits per trajectory printed and held below ``max_hits``); short runs of
   asthma (Multinomial, row simplexes), birats (MvNormal rows and an
   InverseWishart under NUTS) and gk (a user distribution fit by ABC).
   Every run is held to finite draws inside the support and draws
   posterior-predictive data through ``forward_sample``; no draw may come
   from a global generator;
10. GLMM ChEES at full width: ADVI on the generic build, then ChEES-HMC
    through the fused kernel, 1024 chains, a short run;
11. post: the output layer on the 1024-chain pumps and jaws runs of phases
    8 and 9 (``gelmandiag`` with MPSRF on the link scale, ``dic``,
    ``logpdf_chains`` against ``compiled.logpdf``, ``predict`` inside the
    data's support, a restart from a chain file bit-identical to the
    restart from memory, SVG plots), the per-chain diagnostics on rats
    ChEES's first 8 chains, and ``logpdf_chains``/``dic`` of the recovery
    run through the kernel against the generic build;
12. map: ``optim_over`` (L-BFGS) on the full-width GLMM through the kernel,
    against the truth, the inits and the generic build; a MAP warm start
    of line;
13. smc: the conjugate model and line under the gates of
    tests/test_infer.py, and the G = 64 GLMM through the kernel's ``vmap``
    rule over 1024 particles;
14. profile: a ``torch.profiler`` trace of full-width gradients that names
    the kernel, ``time_compiled`` against phase 3's CUDA events, the card's
    peaks and the kernel's bound from ``utils/roofline.py``, its
    ``roofline`` reading and the elementwise ceiling;
15. mesh (``parallel/``, after phase 10): (a) ``graft_entry.dryrun_multichip(1)``;
    (b) phase 10's GLMM ChEES run through ``mcmc(mesh=)`` on a one-rank NCCL
    mesh in this process; (c) the same run in two processes over gloo on
    this one card, 512 chains each, their draws gathered on both and their
    step size and trajectory equal after every iteration; (d) in the same
    two processes, a (1, 2) data mesh: the GLMM's block density and
    gradient at 1024 chains from the kernel over each rank's 5,000 groups,
    summed over the data group, against one launch over all groups, under
    phase 3's gates; the kernel at a rank's shares (C = 512; G = 5,000;
    C = 513, G = 5,000, not a multiple of its 4-chain tile) against its
    plain version, the first two timed with their bounds.  Both ranks share
    the one card: no number of (c) or (d) is a scaling figure.

    python3 chip_smoke.py --mesh-rank <init_method> <rank> <dir>

runs one rank of (c) and (d).

The kernel's paths (phases 5, 10, 12, 13 and 15's runs) each set its launch
count to 0 just before they run and read it just after.  Every phase raises on
failure.  The whole run takes 15 to 18 minutes on an H100, 2 to 3 of them in
rats NUTS, 5 to 6 in the zoo and 3 in zoo_mv; the paths are host-bound,
so the time follows the host's CPU, and each phase's wall is printed.  The
last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it lists the kernel with its launches on the main paths, its
error, its time, the plain version's, and the least time the card could take
(``bound_ms``, from ``ops.fused_glmm.glmm_bound_ms``: the floors set by
memory, float32 arithmetic and the special-function pipe are in
``floors_ms``, for the kernel's arithmetic and for the form with a polynomial
logarithm; ``bound_floor`` names the one that sets the bound).  With no CUDA device the script exits with status 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: phase-3 cases: C chains, G groups, and unless given n = 10 observations
#: and P = 4 effects, which is the shape the register kernel is compiled for;
#: P = 3, n = 7 takes the generic kernel.  ``near_mode`` takes the GLMM's own
#: data with every chain close to the truth, where grad_beta cancels.
KERNEL_CASES = (
    {"C": 1024, "G": 10_000},
    {"C": 1000, "G": 9_999},
    {"C": 1, "G": 37},
    {"C": 33, "G": 300, "P": 3, "n": 7},
    {"C": 1024, "G": 10_000, "near_mode": True},
)
#: lp relative error: a sum of 100k negative terms has no cancellation
LP_RTOL = 1e-5
#: gradient error max|d| / max|g_ref| over (grad_beta, grad_b): every
#: contraction is float32 FMA
GRAD_RTOL = 1e-4

CHAINS = 1024
#: GLMM NUTS at full width (phase 5): iterations, burnin
GLMM_NUTS_RUN = (10, 5)
#: rats NUTS headline (phase 6), cut from bench.py's 1500/500
#: (bench.py:39-46): at 1024 chains the warmup trees are 9-10 deep and each
#: leapfrog costs 5 to 9 ms of host time, by the host's load, so these 30
#: iterations take 2 to 3 minutes.  Cut from 50/25 when zoo_mv came in;
#: the mean over 1024 chains still clears the mu_beta gate (PERF.md §4)
RATS_NUTS_RUN = (30, 15)
#: rats ChEES (phase 7), bench.py:63-98
RATS_CHEES_RUN = (1500, 500)
#: GLMM ChEES at full width (phase 10); depth cut from bench.py's 1300/300
GLMM_CHEES_RUN = (20, 10)
#: zoo (phase 8): model, scheme, iterations, burnin, and the gates of the JAX
#: package's golden test of that model, {label: (golden mean, tolerance)}
#: (tests/test_models_golden.py).  Those tests run 2 chains for 6,000-8,000
#: iterations; with 1024 chains the kept draws can be few, and the depth is
#: what the over-dispersed second init needs to reach the posterior under
#: the reference's proposal widths.  No run keeps ``MIN_KEPT`` draws, so rank
#: R-hat is printed and not gated: seeds' AMM + AMWG scheme is far from it at
#: this depth in the JAX package too (its s2 collapses from b = 0 and takes
#: about 8,000 iterations to come back).  pumps was cut from 300/250,
#: surgical from 400/350 and mice from 600/500, each where a CPU run at 64
#: chains still cleared every gate (PERF.md §4); seeds and the zoo_mv runs
#: keep their depths, their gates' margins being thin.
ZOO_RUNS = (
    ("pumps", None, 280, 250, {"alpha": (0.6968, 0.08), "beta": (0.9304, 0.16),
                               "theta[1]": (0.0599, 0.01)}),
    ("surgical", None, 300, 250, {"mu": (-2.550, 0.12),
                                  "pop_mean": (0.0731, 0.01),
                                  "p[1]": (0.0536, 0.012)}),
    ("seeds", "reference", 2000, 1600, {"alpha0": (-0.5562, 0.15),
                                        "alpha12": (-0.7464, 0.3),
                                        "s2": (0.0857, 0.07)}),
    ("mice", None, 450, 400, {"r": (3.27, 0.45), "median[1]": (22.8, 1.5),
                              "median[2]": (26.5, 1.8)}),
)
#: zoo_mv (phase 9): the models of the multivariate half of the zoo, each
#: with its ``build()`` scheme and both inits, at 1024 chains: model, scheme,
#: iterations, burnin, and the gates {label: (golden mean, tolerance)} of the
#: JAX package's golden test of that model (tests/test_models_golden.py).
#: Runs with no gates are short runs, held to finite draws inside their
#: support, their means printed beside ``GOLDEN``; pollution's DGS run is held
#: to gamma[9] > 0.8 and gamma[2] < 0.6 instead.  Depths are what the
#: over-dispersed inits need (CPU runs at 64 chains in both packages): eyes'
#: lam[2] clears its gate after ~1,000 iterations, jaws' Sigma[4,4] after
#: ~250, line_abc's beta[1] after ~150.
ZOO_MV_RUNS = (
    ("eyes", None, 1100, 1050, {"P[1]": (0.6036, 0.08), "lam[1]": (536.753, 1.5),
                                "lam[2]": (548.987, 1.5)}),
    ("jaws", None, 400, 300, {"beta1": (1.8743, 0.1), "Sigma[1,1]": (6.7916, 1.5),
                              "Sigma[4,4]": (8.0594, 1.8)}),
    ("pollution", "dgs", 300, 200, {}),
    ("pollution", "bhmc", 6, 3, {}),
    ("pollution", "bmc3", 40, 20, {}),
    ("pollution", "bmg", 40, 20, {}),
    ("pollution", "bia", 40, 20, {}),
    ("line_abc", None, 300, 200, {"beta[1]": (0.7235, 0.4),
                                  "beta[2]": (0.7747, 0.15),
                                  "s2": (1.3074, 0.9)}),
    ("asthma", None, 40, 20, {}),
    ("birats", None, 4, 2, {}),
    ("gk", None, 60, 30, {}),
)
#: GLMM recovery (phase 4): iterations, burnin; cut from 400/150:
#: the beta gate is 0.35, and the error was 0.194 at 200/100 on the card and
#: 0.198 at 150/75 on the CPU (the posterior mean of this data lies ~0.17
#: from the truth; PERF.md §4)
RECOVERY_RUN = (150, 75)
#: the post phase's runs, reused from the zoo and zoo_mv phases: models whose
#: sampled nodes are all monitored (dic and predict need their draws)
POST_ZOO = ("pumps", "jaws")
#: iterations of each restart in the post phase (from the file, from memory)
POST_RESTART = 20
#: stored draws at which logpdf_chains is held against compiled.logpdf, and
#: the relative tolerance (float32 sums of tens of terms)
POST_DIRECT_DRAWS, POST_DIRECT_RTOL = 16, 1e-5
#: fused against generic modelstats on the recovery run (float32 GLMM
#: likelihoods over 640 observations, summed in another order)
POST_FUSED_RTOL = 1e-4
#: rats ChEES chains the per-chain diagnostics run on (host loops)
POST_DIAG_CHAINS = 8
#: the map phase: the largest error of the MAP beta at G = 10,000 against the
#: truth, and of the fused build's (float32, through the kernel) against the
#: generic build's in float64.  On the CPU both packages give a MAP beta
#: 0.1304 from the truth at this G in float64 (the joint mode of a logistic
#: model with 10 observations per group lies farther from zero than the
#: truth), and the port's fused float32 MAP lies 5e-5 from the float64 one
#: (PERF.md §6)
MAP_BETA_TOL = 0.15
MAP_FUSED_TOL = 1e-3
#: the smc phase's particles; the GLMM's beta gate is the recovery gate, and
#: its run takes 20 RWM steps per stage: with the default 10, four seeds
#: gave beta 0.17-0.28 from the truth in float32 on the CPU (the posterior
#: mean lies 0.17 from it), with 20 0.16-0.22 (PERF.md §6)
SMC_PARTICLES, SMC_GLMM_PARTICLES, SMC_BETA_TOL = 4096, 1024, 0.35
SMC_GLMM_STEPS = 20
#: the profile phase: full-width gradients traced, and how far
#: time_compiled's time may lie from phase 3's CUDA-event time
PROFILE_GRADIENTS, PROFILE_TIME_RTOL = 5, 0.2
#: the mesh phase: the two processes of (c) and (d) must end within this
#: many seconds, and a collective may wait this many
MESH_RANKS_TIMEOUT, MESH_GROUP_TIMEOUT = 300, 120
#: the mesh phase's model width (phase 10's)
MESH_G = 10_000
#: convergence gates of bench.py:48-52
RHAT_MAX = 1.01
ESS_MIN = 400.0
#: kept draws below which a cut run is not held to R-hat and ESS
MIN_KEPT = 500
#: rats golden mu_beta (doc/examples/rats.rst:42-47) and the gate on it
MU_BETA, MU_BETA_TOL = 6.1831, 0.1
#: where the main paths run
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


def sm_clocks_mhz():
    """The card's SM clock now and at its most, in MHz."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    now, most = smi.stdout.strip().splitlines()[0].split(",")
    return float(now), float(most)


def phase_build(fg):
    t0 = time.perf_counter()
    fg.build_library()
    fg._lib()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for line in fg.BUILD_LOG.read_text().splitlines():
        if "ptxas" in line and ("registers" in line or "Compiling" in line):
            log("  " + line.strip())


def _event_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_case(torch, fg, glmm_cases, C, G, n=10, P=4, seed=0, near_mode=False,
                time_reps=0):
    """Kernel (float32) against the plain version in float64 on the same
    inputs, with the float32 plain version's own errors beside it; with
    ``time_reps`` also ms per call of the kernel and of the float32 plain
    version."""
    arrays = (glmm_cases.near_mode_inputs(G, C, seed, n=n) if near_mode
              else glmm_cases.random_inputs(P, n, G, C, seed))
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                 for a in arrays)
    plan = fg.kernel_plan(P, n, G, C)
    lp, gbeta, gb = fg.glmm_loglik_grads(*args)
    torch.cuda.synchronize()
    ref = fg.glmm_loglik_grads_plain(*(a.double() for a in args))
    out = {"C": C, "G": G, "n": n, "P": P, "near_mode": near_mode, **plan,
           **glmm_cases.glmm_errors((lp, gbeta, gb), ref)}
    plain32 = glmm_cases.glmm_errors(fg.glmm_loglik_grads_plain(*args), ref)
    out["plain_float32"] = {k: plain32[k] for k in ("grad_rel_err",
                                                     "gbeta_rel_err")}
    del ref
    # bit-for-bit reproducible: no float atomics in the reduction
    lp2, gbeta2, gb2 = fg.glmm_loglik_grads(*args)
    out["reproducible"] = bool(torch.equal(lp, lp2) and torch.equal(gbeta, gbeta2)
                               and torch.equal(gb, gb2))
    if time_reps:
        kern = lambda: fg.glmm_loglik_grads(*args)           # noqa: E731
        plain = lambda: fg.glmm_loglik_grads_plain(*args)    # noqa: E731
        for fn in (kern, plain):
            fn()
        # alternate plain, kernel, kernel, plain on one card
        p1 = _event_ms(torch, plain, time_reps)
        k1 = _event_ms(torch, kern, time_reps)
        k2 = _event_ms(torch, kern, time_reps)
        p2 = _event_ms(torch, plain, time_reps)
        out.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                   ms_runs=[k1, k2], plain_ms_runs=[p1, p2])
        clock_now, clock_max = sm_clocks_mhz()
        bound = fg.glmm_bound_ms(P, n, G, C, 1e6 * clock_max)
        out.update(bound=bound, sm_clock_mhz=clock_now,
                   sm_clock_max_mhz=clock_max,
                   pct_of_bound=100 * bound["bound_ms"] / out["ms"])
    log("kernel vs plain: " + json.dumps(out))
    if not (out["lp_rel_err"] <= LP_RTOL and out["grad_rel_err"] <= GRAD_RTOL):
        raise AssertionError(f"fused GLMM kernel disagrees with its plain "
                             f"version at C={C}, G={G}: {out}")
    if not out["reproducible"]:
        raise AssertionError(f"fused GLMM kernel is not reproducible at C={C}, G={G}")
    want = "glmm_reg_kernel" if (P, n) == (4, 10) else "glmm_generic_kernel"
    if plan["kernel"] != want:
        raise AssertionError(f"P={P}, n={n} ran {plan['kernel']}, not {want}")
    return out


def phase_kernels(torch, fg, glmm_cases):
    return [kernel_case(torch, fg, glmm_cases, **case, time_reps=20 if i == 0 else 0)
            for i, case in enumerate(KERNEL_CASES)]


def _recording(module, name, pick):
    """Wrap ``module.name`` so every call's ``pick(output)`` is appended to a
    list (the smoke test's own instrument; the sampler is unchanged).
    Returns the list and a function that restores the original."""
    seen = []
    inner = getattr(module, name)

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(pick(out))
        return out

    setattr(module, name, recording)
    return seen, lambda: setattr(module, name, inner)


def _record_depths(nuts):
    """Every NUTS transition's per-chain tree depth."""
    return _recording(nuts, "nuts_sub", lambda out: out[3].detach().cpu())


def _nuts_work(torch, depths):
    """Mean and max tree depth, and the leapfrog steps the lockstep chains
    evaluated: an iteration costs the deepest chain's 2**depth - 1."""
    d = torch.stack(depths)                    # (iterations, chains)
    return {"mean_tree_depth": float(d.float().mean()),
            "max_tree_depth": int(d.max()),
            "leapfrog_steps": int((2 ** d.max(dim=1).values.long() - 1).sum())}


def _timing(sim, chains, iters):
    t = sim.timing
    return {"setup_s": t["setup_s"], "sample_s": t["sample_s"],
            "fetch_s": t["fetch_s"],
            "chain_iters_per_s": chains * iters / t["sample_s"]}


def _monitor(model, name):
    """``model`` with node ``name`` monitored (its draws stored)."""
    import dataclasses
    model.nodes[name] = dataclasses.replace(model.nodes[name], monitor=True)
    return model


def phase_recovery(mt, glmm):
    iters, burnin = RECOVERY_RUN
    model, inputs, inits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                             mass_window=50)
    # z stored too, so that the post phase can rebuild every draw's state
    model = _monitor(model, "z")
    sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=4,
                  verbose=False, device=DEVICE)
    s = mt.summarystats(sim).to_dict()
    est = np.array([s[f"beta[{i + 1}]"]["Mean"] for i in range(4)])
    err = float(np.abs(est - truth["beta"]).max())
    log(f"recovery (G=64, 4 chains, {iters} iters, {burnin} burnin): beta means "
        f"{est.round(4).tolist()} vs truth {truth['beta'].tolist()}, max error "
        f"{err:.4f}; sample_s {sim.timing['sample_s']:.2f}")
    if not err < 0.35:
        raise AssertionError(f"beta not recovered: max error {err}")
    return sim


def _check_glmm_draws(sim, iters, burnin, chains):
    v = sim.value
    if v.shape != (iters - burnin, 5, chains) or not np.isfinite(v).all():
        raise AssertionError(f"kept draws: shape {v.shape}, finite "
                             f"{np.isfinite(v).all()}")
    if not (v[:, sim.names.index("s2"), :] > 0).all():
        raise AssertionError("s2 left its support")


def phase_glmm_nuts(torch, mt, glmm, fg, nuts):
    iters, burnin = GLMM_NUTS_RUN
    model, inputs, inits, _ = glmm.build(G=10_000, n=10, seed=0, fused=True)
    depths, restore = _record_depths(nuts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fg.glmm_loglik_grads.launches = 0          # count this path only
    try:
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    launches = fg.glmm_loglik_grads.launches
    res = {**_timing(sim, CHAINS, iters), **_nuts_work(torch, depths),
           "kernel_launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    log(f"GLMM NUTS at full width (G=10000, n=10, P=4, {CHAINS} chains, "
        f"{iters} iters, {burnin} burnin): " + json.dumps(res))
    _check_glmm_draws(sim, iters, burnin, CHAINS)
    if launches < res["leapfrog_steps"] or launches == 0:
        raise AssertionError(f"the fused kernel ran {launches} times for "
                             f"{res['leapfrog_steps']} leapfrog steps")
    return res


def _rats_gates(mt, rats, sim, name):
    """bench.py's gates on a rats run; raises on any failure.  A run cut
    below ``MIN_KEPT`` kept draws cannot reach rank R-hat < 1.01
    (bench.py:41-46), so there R-hat and bulk ESS are printed, not gated."""
    v = sim.value
    converge = v.shape[0] >= MIN_KEPT
    s = mt.summarystats(sim).to_dict()
    rhat = float(np.max(mt.rhat_rank(v)))
    ess = mt.ess_bulk(v)
    ess_s = np.array([s[k]["ESS"] for k in sim.names]) / sim.timing["sample_s"]
    state = sim.states["state"]
    variances = {k: bool((state[k] > 0).all()) for k in ("s2_c", "s2_alpha",
                                                         "s2_beta")}
    out = {"mu_beta_mean": s["mu_beta"]["Mean"],
           "s2_c_mean": s["s2_c"]["Mean"], "alpha0_mean": s["alpha0"]["Mean"],
           "rhat_rank_max": rhat, "ess_bulk_min": float(np.min(ess)),
           "ess_per_s_total": float(ess_s.sum()),
           "ess_per_s_min": float(ess_s.min()),
           "finite": bool(np.isfinite(v).all()),
           "kept_s2_c_positive": bool((v[:, sim.names.index("s2_c"), :] > 0).all()),
           "final_variances_positive": variances,
           "kept_draws": v.shape[0], "convergence_gated": converge}
    log(f"{name} gates: " + json.dumps(out))
    failed = []
    if not abs(out["mu_beta_mean"] - MU_BETA) < MU_BETA_TOL:
        failed.append("golden mu_beta")
    if converge and not rhat < RHAT_MAX:
        failed.append("rank R-hat")
    if converge and not out["ess_bulk_min"] > ESS_MIN:
        failed.append("bulk ESS")
    if not (out["finite"] and out["kept_s2_c_positive"] and all(variances.values())):
        failed.append("finite draws and positive variances")
    if failed:
        raise AssertionError(f"{name}: gates failed: {failed}: {out}")
    return out


def phase_rats_nuts(torch, mt, rats, nuts):
    iters, burnin = RATS_NUTS_RUN
    model, inputs, inits = rats.build("nuts")
    depths, restore = _record_depths(nuts)
    try:
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    res = {**_timing(sim, CHAINS, iters), **_nuts_work(torch, depths)}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    log(f"rats NUTS ({CHAINS} chains, {iters} iters, {burnin} burnin): "
        + json.dumps(res))
    res.update(_rats_gates(mt, rats, sim, "rats NUTS"))
    return res


def _advi_warm_inits(torch, mt, model, inputs, init, steps, chains):
    """bench.py's ADVI warm start: fit, then one draw from q per chain."""
    t0 = time.perf_counter()
    res = mt.advi(model, inputs, init, steps=steps, nmc=4, seed=1, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    draws = {k: v.cpu().numpy() for k, v in res.sample(gen, chains).items()}
    advi_s = time.perf_counter() - t0
    inits = [dict(init, **{k: d[i] for k, d in draws.items()})
             for i in range(chains)]
    trace = res.elbo_trace
    log(f"ADVI ({steps} steps, nmc 4): {advi_s:.2f} s, ELBO first/last "
        f"{trace[0]:.2f} / {trace[-1]:.2f}")
    if not np.isfinite(trace[-1]):
        raise AssertionError("ADVI ELBO is not finite")
    return inits, advi_s


def _chees_block(mt, model, **kw):
    """The model's gradient block (its first) as ChEES-HMC, as bench.py
    sets it; later blocks stay."""
    model.set_samplers([mt.ChEESHMC(model.samplers[0].params, **kw),
                        *model.samplers[1:]])
    return model


def phase_rats_chees(torch, mt, rats, chees):
    iters, burnin = RATS_CHEES_RUN
    model, inputs, inits = rats.build("nuts")
    model = _chees_block(mt, model, mass_window=50)
    warm, advi_s = _advi_warm_inits(torch, mt, model, inputs, inits[0], 1500,
                                    CHAINS)
    steps, restore = _recording(chees, "_steps", lambda L: L)
    try:
        sim = mt.mcmc(model, inputs, warm, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    res = {**_timing(sim, CHAINS, iters), "advi_s": advi_s,
           "leapfrog_steps": sum(steps), "mean_L": float(np.mean(steps)),
           "max_L": max(steps)}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    log(f"rats ChEES ({CHAINS} chains, {iters} iters, {burnin} burnin): "
        + json.dumps(res))
    res.update(_rats_gates(mt, rats, sim, "rats ChEES"))
    return res, sim


def zoo_run(torch, mt, name, scheme, iters, burnin, gates):
    """One zoo model at 1024 chains under its golden gates; raises on any
    failure."""
    import importlib
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    model, inputs, inits = mod.build() if scheme is None else mod.build(scheme)
    sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=CHAINS,
                  verbose=False, device=DEVICE)
    v = sim.value
    s = mt.summarystats(sim).to_dict()
    kept = iters - burnin
    converge = kept >= MIN_KEPT
    res = {"model": name, "blocks": [repr(b) for b in model.samplers],
           "iterations": iters, "burnin": burnin, **_timing(sim, CHAINS, iters),
           "wall_ms_per_iteration": 1e3 * sim.timing["sample_s"] / iters,
           "means": {k: s[k]["Mean"] for k in gates},
           "golden": {k: g[0] for k, g in gates.items()},
           "rhat_rank_max": float(np.max(mt.rhat_rank(v))),
           "convergence_gated": converge,
           "finite": bool(np.isfinite(v).all())}
    # posterior-predictive draws of the data nodes on the card (Poisson,
    # Binomial, truncated Weibull), from a generator of the script's own:
    # finite and inside their support (outside it the density is -inf)
    cm = sim.compiled
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    state = sim.states["state"]
    sampled = {p for b in model.samplers if not isinstance(b, mt.MISS)
               for p in b.params}
    data = tuple(n for n in cm.stochastic if n not in sampled)
    drawn = cm.forward_sample(gen, state, names=data)
    res["predictive_nodes"] = list(data)
    res["forward_sample_ok"] = bool(data) and all(
        tuple(drawn[n].shape) == tuple(state[n].shape)
        and bool(torch.isfinite(drawn[n]).all()) for n in data
    ) and bool(torch.isfinite(torch.func.vmap(
        lambda st: cm.logpdf(st, data))(drawn)).all())
    log(f"zoo {name}: " + json.dumps(res))
    failed = [k for k, (mean, tol) in gates.items()
              if not abs(res["means"][k] - mean) < tol]
    if v.shape != (kept, len(sim.names), CHAINS) or not res["finite"]:
        failed.append("finite draws of the expected shape")
    if converge and not res["rhat_rank_max"] < RHAT_MAX:
        failed.append("rank R-hat")
    if not res["forward_sample_ok"]:
        failed.append("forward_sample")
    if failed:
        raise AssertionError(f"zoo {name}: gates failed: {failed}: {res}")
    return res, sim


def phase_zoo(torch, mt):
    """The zoo's runs; returns their results and the chains of the runs the
    post phase reuses (``POST_ZOO``)."""
    # no draw may come from the global generators: their states must not move
    before = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    out, sims = [], {}
    for run in ZOO_RUNS:
        res, sim = zoo_run(torch, mt, *run)
        out.append(res)
        if run[0] in POST_ZOO:
            sims[run[0]] = sim
    after = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("zoo: a draw came from a global generator")
    return out, sims


def _predictive(torch, mt, cm, model, state):
    """Posterior-predictive draws of the data nodes through
    ``forward_sample``, from a generator of the script's own: the names, and
    whether every draw has its node's shape, is finite and (where the node
    has a density) inside its support."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    sampled = {p for b in model.samplers if not isinstance(b, mt.MISS)
               for p in b.params}
    data = tuple(n for n in cm.stochastic if n not in sampled)
    drawn = cm.forward_sample(gen, state, names=data)
    ok = bool(data) and all(
        tuple(drawn[n].shape) == tuple(state[n].shape)
        and bool(torch.isfinite(drawn[n]).all()) for n in data)
    try:
        lp = torch.func.vmap(lambda st: cm.logpdf(st, data))(drawn)
        ok = ok and bool(torch.isfinite(lp).all())
    except NotImplementedError:     # gk's data node has no density
        pass
    return list(data), ok


def _in_support(torch, name, sim):
    """The support checks of the zoo_mv table: kept simplex rows inside the
    simplex, final covariance matrices positive definite, binary draws in
    {0, 1}; every draw finite."""
    v, names = sim.value, sim.names
    state = sim.states["state"]
    ok = bool(np.isfinite(v).all())
    if name == "eyes":
        P = v[:, [names.index("P[1]"), names.index("P[2]")], :]
        ok = ok and bool(((P > 0) & (P < 1)).all())
        ok = ok and bool((torch.abs(state["P"].sum(-1) - 1) < 1e-5).all())
    if name == "asthma":
        q = state["q"]
        ok = ok and bool(((q > 0) & (q < 1)).all()
                         and (torch.abs(q.sum(-1) - 1) < 1e-5).all())
    if name in ("jaws", "birats"):
        ok = ok and bool((torch.linalg.eigvalsh(state["Sigma"].double()) > 0).all())
    if name == "pollution":
        ok = ok and set(np.unique(v).tolist()) <= {0.0, 1.0}
    return ok


def zoo_mv_run(torch, mt, binary, name, scheme, iters, burnin, gates):
    """One model of the multivariate half of the zoo at 1024 chains under
    its gates; raises on any failure."""
    import importlib
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    model, inputs, inits = mod.build() if scheme is None else mod.build(scheme)
    hits, restore = _recording(binary, "bhmc_step",
                               lambda out: out[1].wallhits.detach().cpu())
    try:
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    v = sim.value
    means = v.mean(axis=(0, 2))
    golden = getattr(mod, "GOLDEN", {})
    label = name if scheme is None else f"{name}:{scheme}"
    res = {"model": label, "blocks": [repr(b) for b in model.samplers],
           "iterations": iters, "burnin": burnin, **_timing(sim, CHAINS, iters),
           "wall_ms_per_iteration": 1e3 * sim.timing["sample_s"] / iters,
           "means": {k: float(means[sim.names.index(k)]) for k in golden
                     if k in sim.names},
           "golden": {k: g["Mean"] for k, g in golden.items()},
           "in_support": _in_support(torch, name, sim)}
    if gates:
        s = mt.summarystats(sim).to_dict()
        res["gated_means"] = {k: s[k]["Mean"] for k in gates}
    if hits:                                   # BHMC: hits per trajectory
        per = torch.diff(torch.stack([torch.zeros_like(hits[0])] + hits), dim=0)
        res["bhmc_wall_hits_per_trajectory"] = {
            "mean": float(per.float().mean()), "max": int(per.max()),
            "max_hits": 10000}
    if name == "pollution" and scheme == "dgs":
        res["alphabeta_float32_error_sd"] = _alphabeta_float32_error(
            torch, sim.compiled, sim.states["state"])
    if any(isinstance(b, mt.DGS) for b in model.samplers):
        res["dgs_sweep"] = _dgs_graph_check(torch, mt, sim.compiled, model,
                                            sim.states["state"])
    res["predictive_nodes"], res["forward_sample_ok"] = _predictive(
        torch, mt, sim.compiled, model, sim.states["state"])
    log(f"zoo_mv {label}: " + json.dumps(res))
    failed = [k for k, (mean, tol) in gates.items()
              if not abs(res["gated_means"][k] - mean) < tol]
    if v.shape != (iters - burnin, len(sim.names), CHAINS) or not res["in_support"]:
        failed.append("finite draws of the expected shape inside the support")
    if name == "pollution" and scheme == "dgs":
        g = res["means"]
        if not (g["gamma[9]"] > 0.8 and g["gamma[2]"] < 0.6):
            failed.append("gamma[9] > 0.8 and gamma[2] < 0.6")
    if "dgs_sweep" in res and not res["dgs_sweep"]["graph_equals_eager"]:
        failed.append("the DGS sweep replayed from its CUDA graph")
    if hits and not res["bhmc_wall_hits_per_trajectory"]["max"] < 10000:
        failed.append("a BHMC trajectory reached max_hits")
    if not res["forward_sample_ok"]:
        failed.append("forward_sample")
    if failed:
        raise AssertionError(f"zoo_mv {label}: gates failed: {failed}: {res}")
    return res, sim


def _dgs_graph_check(torch, mt, cm, model, state, reps=5):
    """The model's DGS block at the run's final state, replayed from its
    CUDA graph by the engine's kernel and run eagerly by the stand-alone
    ``dgs_step`` from the same generator state: whether the draws are equal,
    and the wall ms per sweep of each."""
    from mamba_tpu_torch.samplers import dgs
    from mamba_tpu_torch.samplers.base import candidate_logf
    (name,) = next(b for b in model.samplers if isinstance(b, mt.DGS)).params
    kern = mt.DGS(name).build(cm)
    tune = kern.init(None, state)
    pack, _, _, logf = cm.block_functions((name,), False)
    x = torch.func.vmap(pack)(state)
    f = candidate_logf(torch.func.vmap(logf), state)
    runs = {"graph": lambda gen: kern.step(gen, state, tune, False)[0][name],
            "eager": lambda gen: dgs.dgs_step(gen, x, tune[0], f)[0]}
    out, ms = {}, {}
    for which, run in runs.items():
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(3)
        out[which] = run(gen).reshape(x.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run(gen)
        torch.cuda.synchronize()
        ms[which] = 1e3 * (time.perf_counter() - t0) / reps
    return {"graph_equals_eager": bool(torch.equal(out["graph"], out["eager"])),
            "graph_ms": ms["graph"], "eager_ms": ms["eager"]}


def _alphabeta_float32_error(torch, cm, state):
    """pollution's conjugate (alpha, beta) mean solved in float32 against the
    float64 solve the model uses, at the run's final state: the largest
    error over chains and coordinates, in posterior standard deviations."""
    from mamba_tpu_torch.models import pollution
    env = {**cm.inputs, **torch.func.vmap(cm.eval_logicals)(state)}
    mu64, L64 = pollution.alphabeta_moments(env, torch.float64)
    mu32, _ = pollution.alphabeta_moments(env, torch.float32)
    eye = torch.eye(L64.shape[-1], dtype=torch.float64, device=L64.device)
    sd = torch.sqrt(torch.diagonal(torch.cholesky_solve(eye.expand_as(L64), L64),
                                   dim1=-2, dim2=-1))
    return float(torch.nan_to_num((mu32.double() - mu64).abs() / sd,
                                  nan=float("inf")).max())


def phase_zoo_mv(torch, mt):
    from mamba_tpu_torch.samplers import binary
    before = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    out, sims = [], {}
    for run in ZOO_MV_RUNS:
        res, sim = zoo_mv_run(torch, mt, binary, *run)
        out.append(res)
        if run[0] in POST_ZOO and run[1] is None:
            sims[run[0]] = sim
    after = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("zoo_mv: a draw came from a global generator")
    return out, sims


def _glmm_chees_run(torch, mt, glmm, fg, chees, warm, label, **mesh_kw):
    """Phase 10's run: the GLMM at full width under ChEES-HMC from the ADVI
    draws ``warm``, on ``mesh_kw``'s mesh if given.  Gated on finite draws
    of the run's shape and on kernel launches >= gradient evaluations;
    returns its numbers, the draws and (epsilon, traj) after every
    iteration."""
    iters, burnin = GLMM_CHEES_RUN
    model, inputs, _, _ = glmm.build(MESH_G, fused=True)
    model = _chees_block(mt, model, max_steps=256, mass_window=40)
    steps, restore_steps = _recording(chees, "_steps", lambda L: L)
    tunes, restore_tunes = _recording(
        chees, "chees_step",
        lambda out: [float(out[1].epsilon), float(out[1].traj)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fg.glmm_loglik_grads.launches = 0          # count this path only
    try:
        sim = mt.mcmc(model, inputs, warm, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE, **mesh_kw)
    finally:
        restore_steps()
        restore_tunes()
    launches = fg.glmm_loglik_grads.launches
    need = sum(L + 1 for L in steps)           # logfgrad at x, then L steps
    res = {**_timing(sim, CHAINS, iters),
           "steps_per_iteration": steps, "leapfrog_steps": sum(steps),
           "kernel_launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    res["wall_ms_per_gradient"] = 1e3 * res["sample_s"] / need
    log(f"{label} (G={MESH_G}, {CHAINS} chains, {iters} iters, {burnin} "
        f"burnin): " + json.dumps(res))
    _check_glmm_draws(sim, iters, burnin, CHAINS)
    if launches < need or launches == 0:
        raise AssertionError(f"{label}: the fused kernel ran {launches} times "
                             f"for {need} gradient evaluations")
    return res, sim, tunes


def _glmm_warm_inits(torch, mt, glmm):
    """bench.py's warm start of the GLMM: ADVI on the generic build (the
    same posterior and sites), one draw per chain, y from the fused build."""
    _, _, inits, _ = glmm.build(MESH_G, fused=True)
    model_g, inputs_g, inits_g, _ = glmm.build(MESH_G, fused=False)
    warm, advi_s = _advi_warm_inits(torch, mt, model_g, inputs_g, inits_g[0],
                                    1000, CHAINS)
    return [dict(inits[0], **{k: w[k] for k in ("beta", "z", "s2")})
            for w in warm], advi_s


def phase_glmm_chees(torch, mt, glmm, fg, chees):
    warm, advi_s = _glmm_warm_inits(torch, mt, glmm)
    res, _, tunes = _glmm_chees_run(torch, mt, glmm, fg, chees, warm,
                                    "GLMM ChEES at full width")
    return {**res, "advi_s": advi_s}, warm, tunes


def _split_density_check(torch, mt, glmm, fg, mesh, warm):
    """(d): the GLMM's (beta, z, s2) block density and gradient at every
    warm start, from the kernel over this rank's range of groups summed
    over the data group, against one launch over all groups."""
    from mamba_tpu_torch.parallel.mesh import MeshComm
    from mamba_tpu_torch.model.mcmc import _chain_inits
    model, inputs, inits, _ = glmm.build(MESH_G, fused=True)
    whole = mt.compile_model(model, inputs, inits[0], device=DEVICE)
    split = mt.compile_model(model, inputs, inits[0], device=DEVICE,
                             comm=MeshComm(mesh), site_specs={"y": (None, "data")})
    state = _chain_inits(whole, warm, CHAINS)
    params = ("beta", "z", "s2")
    out = {}
    for name, cm in (("whole", whole), ("split", split)):
        pack, _, _, logf = cm.block_functions(params, True)
        x = torch.func.vmap(pack)(state)
        fg.glmm_loglik_grads.launches = 0
        g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, state)
        launches = fg.glmm_loglik_grads.launches
        v, g = cm.block_sum(params)(v, g)
        out[name] = (v.double(), g.double(), launches)
    (v, g, n_split), (vw, gw, n_whole) = out["split"], out["whole"]
    res = {"lp_rel_err": float(((v - vw).abs() / vw.abs()).max()),
           "grad_rel_err": float((g - gw).abs().max() / gw.abs().max()),
           "launches_split": n_split, "launches_whole": n_whole,
           "groups": [split._local_plans["y"][1], split._local_plans["y"][2]]}
    if not (res["lp_rel_err"] <= LP_RTOL and res["grad_rel_err"] <= GRAD_RTOL
            and n_split == 1 and n_whole == 1):
        raise AssertionError(f"(d) the group split disagrees: {res}")
    return res


def mesh_rank(init, rank, outdir):
    """One rank of the mesh phase's (c) and (d): two processes over gloo,
    both on this process's card."""
    import torch
    import torch.distributed as dist
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm
    from mamba_tpu_torch.ops import fused_glmm as fg
    from mamba_tpu_torch.parallel import distributed_init, make_mesh
    from mamba_tpu_torch.samplers import chees
    outdir = Path(outdir)
    with np.load(outdir / "warm.npz") as f:
        warm_arrays = {k: f[k] for k in f.files}
    _, _, inits, _ = glmm.build(MESH_G, fused=True)
    warm = [dict(inits[0], **{k: v[i] for k, v in warm_arrays.items()})
            for i in range(CHAINS)]
    distributed_init(init, 2, rank, device_type="cpu",
                     timeout=MESH_GROUP_TIMEOUT)
    try:
        mesh = make_mesh({"chains": 2}, "cpu")
        res, sim, tunes = _glmm_chees_run(
            torch, mt, glmm, fg, chees, warm,
            f"(c) rank {rank} of a 2-rank gloo chain mesh", mesh=mesh)
        res["tunes"] = tunes
        res["draws_shape"] = list(sim.value.shape)
        res["split"] = _split_density_check(
            torch, mt, glmm, fg, make_mesh({"chains": 1, "data": 2}, "cpu"),
            warm)
        np.save(outdir / f"draws{rank}.npy", sim.value)
        (outdir / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def phase_mesh(torch, mt, glmm, fg, chees, glmm_cases, warm, tunes_10):
    """(a)-(d) of the mesh phase, then the kernel at a rank's shares."""
    import tempfile
    import torch.distributed as dist
    from mamba_tpu_torch.graft_entry import dryrun_multichip
    from mamba_tpu_torch.parallel import make_mesh
    from mamba_tpu_torch.parallel.launch import run_ranks
    res = {}
    t0 = time.perf_counter()
    dryrun_multichip(1, device=DEVICE)                            # (a)
    res["dryrun_s"] = time.perf_counter() - t0
    mesh = make_mesh({"chains": 1})                               # (b)
    probe = torch.full((4,), 2.0, device=DEVICE)
    dist.all_reduce(probe)
    res["backend"] = dist.get_backend()
    want = "nccl" if DEVICE == "cuda" else "gloo"
    if res["backend"] != want or not bool((probe == 2.0).all()):
        raise AssertionError(f"(b) the one-rank mesh: backend "
                             f"{res['backend']}, all_reduce {probe.tolist()}")
    one, _, tunes_b = _glmm_chees_run(torch, mt, glmm, fg, chees, warm,
                                      "(b) one-rank NCCL mesh", mesh=mesh)
    dist.destroy_process_group()
    res["one_rank"] = {k: one[k] for k in ("sample_s", "kernel_launches",
                                           "leapfrog_steps")}
    # a one-rank mesh replays the run without one: chain rank 0 takes the
    # run's seed and an axis of size one takes no collective
    res["one_rank"]["tunes_equal_phase_10"] = tunes_b == tunes_10
    if tunes_b != tunes_10:
        raise AssertionError("(b) the one-rank mesh's (eps, traj) path "
                             "differs from phase 10's")
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:      # (c), (d)
        keys = ("beta", "z", "s2")
        np.savez(Path(tmp) / "warm.npz",
                 **{k: np.stack([np.asarray(w[k], np.float64) for w in warm])
                    for k in keys})
        t0 = time.perf_counter()
        run_ranks(lambda r, init: [sys.executable, str(Path(__file__).resolve()),
                                   "--mesh-rank", init, r, tmp],
                  2, timeout=MESH_RANKS_TIMEOUT)
        res["two_ranks_s"] = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
        draws = [np.load(Path(tmp) / f"draws{r}.npy") for r in range(2)]
    iters, burnin = GLMM_CHEES_RUN
    failed = []
    if not np.array_equal(draws[0], draws[1]) or draws[0].shape != (
            iters - burnin, 5, CHAINS):
        failed.append("(c) both ranks hold every chain's draws")
    if ranks[0]["tunes"] != ranks[1]["tunes"] or len(ranks[0]["tunes"]) != iters:
        failed.append("(c) (epsilon, traj) equal on both ranks")
    res["two_ranks"] = [{k: r[k] for k in ("sample_s", "kernel_launches",
                                            "leapfrog_steps", "draws_shape",
                                            "split")} for r in ranks]
    res["tunes_first_last"] = [ranks[0]["tunes"][0], ranks[0]["tunes"][-1]]
    res["launches"] = one["kernel_launches"] + sum(r["kernel_launches"]
                                                   for r in ranks)
    # the kernel at a rank's shares: C = 512 and G = 5,000 timed with their
    # bounds; 513 chains (1026 over two ranks), not a multiple of 4
    res["kernel"] = [kernel_case(torch, fg, glmm_cases, C=C, G=G,
                                 time_reps=20 if timed else 0)
                     for C, G, timed in ((512, 10_000, True),
                                         (1024, 5_000, True),
                                         (513, 5_000, False))]
    log("mesh: " + json.dumps({k: v for k, v in res.items() if k != "kernel"}))
    for case in res["kernel"][:2]:
        log(f"mesh: kernel at C={case['C']}, G={case['G']}: {case['ms']:.4f} ms, "
            f"bound {case['bound']['bound_ms']:.4f} ms "
            f"({case['pct_of_bound']:.1f}%), plain {case['plain_ms']:.3f} ms")
    if failed:
        raise AssertionError(f"mesh: gates failed: {failed}")
    return res


def _direct_logpdf(sim, chain, draw):
    """``compiled.logpdf`` at stored draw ``draw`` of chain ``chain``, the
    state rebuilt by hand: the chain's final state with every stored
    stochastic site's columns (column-major, Julia ``vec``) put back."""
    cm = sim.compiled
    state = {k: v[chain] for k, v in sim.states["state"].items()}
    for n in cm.stochastic:
        cols = [i for i, lbl in enumerate(sim.names)
                if lbl == n or lbl.startswith(n + "[")]
        if not cols:
            continue
        shape = cm.sites[n].shape
        vals = sim.value[draw, cols, chain].reshape(shape, order="F")
        state[n] = cm.tensor(np.ascontiguousarray(vals))
    return float(cm.logpdf(state))


def _restart_check(mt, sim, build, tmpdir, label):
    """write_chains -> read_chains on the card -> ``POST_RESTART`` more
    iterations, against the same restart from the chains in memory."""
    path = os.path.join(tmpdir, f"{label}.pkl")
    mt.write_chains(path, sim)
    model, inputs, _ = build()
    mc = mt.read_chains(path, model, inputs, device=DEVICE)
    from_file = mt.mcmc(mc, POST_RESTART, verbose=False)
    from_memory = mt.mcmc(sim, POST_RESTART, verbose=False)
    rng = from_file.range
    return {"bit_identical": bool(np.array_equal(from_file.value, from_memory.value)
                                  and np.array_equal(rng, from_memory.range)),
            "contiguous": bool(rng[sim.niter] == sim.iter + sim.thin
                               and np.all(np.diff(rng) == sim.thin)
                               and np.array_equal(from_file.value[:sim.niter],
                                                  sim.value)),
            "iter": from_file.iter}


def post_run(torch, mt, name, sim, tmpdir):
    """The output layer on one zoo run's 1024 chains; raises on failure."""
    import importlib
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    t0 = time.perf_counter()
    g = mt.gelmandiag(sim, mpsrf=True, transform=True)
    d = mt.dic(sim)
    lp = mt.logpdf_chains(sim)
    rng = np.random.default_rng(0)
    picks = [(int(rng.integers(sim.nchains)), int(rng.integers(sim.niter)))
             for _ in range(POST_DIRECT_DRAWS)]
    direct = np.array([_direct_logpdf(sim, c, i) for c, i in picks])
    stored = np.array([lp.value[i, 0, c] for c, i in picks])
    pr = mt.predict(sim, seed=3)
    cm = sim.compiled
    (data,) = sim.model.keys("observed")
    # the predictive draw of each chain's last stored draw, at that draw's
    # own parameters (the chain's final state): finite density = support
    last = {k: v.clone() for k, v in sim.states["state"].items()}
    shape = cm.sites[data].shape
    ys = np.stack([pr.value[-1, :, c].reshape(shape, order="F")
                   for c in range(sim.nchains)])
    last[data] = cm.tensor(ys)
    lp_pred = torch.func.vmap(lambda st: cm.logpdf(st, (data,)))(last)
    restart = _restart_check(mt, sim, mod.build, tmpdir, name)
    files = mt.draw(mt.plot(sim[:, sim.names[:4], list(range(POST_DIAG_CHAINS))]),
                    fmt="svg", filename=os.path.join(tmpdir, name), nrow=2, ncol=2)
    res = {"model": name, "draws": list(sim.value.shape),
           "psrf_max": float(np.nanmax(g.value[:-1, 0, 0])),
           "mpsrf": float(g.value[-1, 0, 0]),
           "dic": d.value[:, 0, 0].tolist(), "pD": float(d.value[0, 1, 0]),
           "pV": float(d.value[1, 1, 0]),
           "logpdf_direct_rel_err": float(np.max(np.abs(stored - direct)
                                                 / np.abs(direct))),
           "predict_shape": list(pr.value.shape),
           "predict_finite": bool(np.isfinite(pr.value).all()),
           "predict_in_support": bool(torch.isfinite(lp_pred).all()),
           "restart": restart, "svg_files": len(files),
           "svg_bytes": sum(os.path.getsize(f) for f in files),
           "wall_s": time.perf_counter() - t0}
    log(f"post {name}: " + json.dumps(res))
    failed = []
    if g.value.shape[0] != sim.nparams + 1 or not np.isfinite(g.value[:-1, 0, 0]).all():
        failed.append("gelmandiag")
    if not (np.isfinite(d.value).all() and res["pD"] > 0):
        failed.append("dic finite with pD > 0")
    if not res["logpdf_direct_rel_err"] <= POST_DIRECT_RTOL:
        failed.append("logpdf_chains against compiled.logpdf")
    if not (res["predict_finite"] and res["predict_in_support"]):
        failed.append("predict inside the support")
    if not (restart["bit_identical"] and restart["contiguous"]):
        failed.append("restart from the file")
    if not (files and all(os.path.getsize(f) > 0 for f in files)):
        failed.append("plot and draw")
    if failed:
        raise AssertionError(f"post {name}: gates failed: {failed}: {res}")
    return res


def _post_fused(torch, mt, glmm, fg, sim):
    """logpdf_chains and dic of the fused recovery run, through the kernel's
    vmap rule over chains x draws, against the same draws on the generic
    build."""
    from mamba_tpu_torch.utils import convert
    fg.glmm_loglik_grads.launches = 0
    lp, d = mt.logpdf_chains(sim), mt.dic(sim)
    launches = fg.glmm_loglik_grads.launches
    model, inputs, _, _ = glmm.build(G=64, n=10, seed=2, fused=False,
                                     mass_window=50)
    model = _monitor(model, "z")
    state = {k: v.cpu().numpy() for k, v in sim.states["state"].items()}
    state["y"] = np.swapaxes(state["y"], 1, 2)      # (n, G) -> (G, n)
    plain = convert.model_chains(sim.value, model, inputs, state,
                                 start=sim.start, thin=sim.thin, names=sim.names,
                                 chains=sim.chains, iter=sim.iter, device=DEVICE)
    lp_g, d_g = mt.logpdf_chains(plain), mt.dic(plain)
    res = {"kernel_launches": launches,
           "logpdf_rel_err": float(np.max(np.abs(lp.value - lp_g.value)
                                          / np.abs(lp_g.value))),
           "dic_rel_err": float(np.max(np.abs(d.value - d_g.value)
                                       / np.abs(d_g.value))),
           "dic": d.value[:, :, 0].tolist()}
    log("post GLMM recovery run, fused against generic: " + json.dumps(res))
    if launches < 1 or not (res["logpdf_rel_err"] <= POST_FUSED_RTOL
                            and res["dic_rel_err"] <= POST_FUSED_RTOL):
        raise AssertionError(f"post: fused modelstats disagree: {res}")
    return res


def phase_post(torch, mt, glmm, fg, zoo_sims, rats_chees_sim, recovery_sim):
    """The output layer on chains the earlier phases made: ``POST_ZOO``'s
    1024-chain runs, the rats ChEES chains and the GLMM recovery run."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmpdir:
        out = {name: post_run(torch, mt, name, zoo_sims[name], tmpdir)
               for name in POST_ZOO}
    c = rats_chees_sim[:, :, list(range(POST_DIAG_CHAINS))]
    tables = {"geweke": mt.gewekediag(c), "heidel": mt.heideldiag(c),
              # the default q = 0.025, r = 0.005 need 3,746 draws
              "raftery": mt.rafterydiag(c, q=0.5, r=0.05)}
    out["rats_chees"] = {k: {"shape": list(t.value.shape),
                             "finite": bool(np.isfinite(t.value[:, :2, :]).all())}
                         for k, t in tables.items()}
    log("post rats ChEES diagnostics (first 8 chains): "
        + json.dumps(out["rats_chees"]))
    if not all(v["finite"] and v["shape"][2] == POST_DIAG_CHAINS
               for v in out["rats_chees"].values()):
        raise AssertionError(f"post: rats ChEES diagnostics: {out['rats_chees']}")
    out["glmm_fused"] = _post_fused(torch, mt, glmm, fg, recovery_sim)
    return out


def _logpdf_at_inits(mt, model, inputs, init):
    cm = mt.compile_model(model, inputs, init, device=DEVICE)
    state = {n: cm.tensor(np.broadcast_to(np.asarray(init[n], dtype=np.float64),
                                          cm.sites[n].shape))
             for n in cm.stochastic}
    return float(cm.logpdf(state))


def phase_map(torch, mt, glmm, fg):
    """MAP by L-BFGS on the full-width GLMM through the kernel, against the
    truth and the generic build; a warm start of line from its MAP."""
    from mamba_tpu_torch.models import line
    t0 = time.perf_counter()
    model, inputs, inits, truth = glmm.build(G=10_000, fused=True)
    lp0 = _logpdf_at_inits(mt, model, inputs, inits[0])
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fg.glmm_loglik_grads.launches = 0          # count this path only
    r = mt.optim_over(model, inputs, inits[0], device=DEVICE)
    torch.cuda.synchronize()
    launches = fg.glmm_loglik_grads.launches
    map_s = time.perf_counter() - t0
    model_g, inputs_g, inits_g, _ = glmm.build(G=10_000, fused=False)
    t0 = time.perf_counter()
    r_g = mt.optim_over(model_g, inputs_g, inits_g[0], device=DEVICE,
                        dtype=torch.float64)
    generic_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lmodel, linputs, linits = line.build()
    r_line = mt.optim_over(lmodel, linputs, linits[0], device=DEVICE)
    warm = mt.mcmc(lmodel, linputs, [r_line.as_inits({"y": linits[0]["y"]})], 20,
                   chains=4, verbose=False, device=DEVICE)
    res = {"beta": r.params["beta"].tolist(), "truth": truth["beta"].tolist(),
           "beta_err": float(np.abs(r.params["beta"] - truth["beta"]).max()),
           "s2": float(r.params["s2"]), "logpdf": r.logpdf,
           "logpdf_inits": lp0, "converged": r.converged, "niter": r.niter,
           "map_s": map_s, "kernel_launches": launches,
           "generic_beta": r_g.params["beta"].tolist(),
           "fused_vs_generic": float(np.abs(r.params["beta"]
                                            - r_g.params["beta"]).max()),
           "generic_niter": r_g.niter, "generic_s": generic_s,
           "line_beta": r_line.params["beta"].tolist(),
           "warm_start_finite": bool(np.isfinite(warm.value).all()),
           "setup_s": setup_s, "line_s": time.perf_counter() - t0}
    log("map (G=10000, fused float32 against generic float64, lbfgs): "
        + json.dumps(res))
    failed = []
    if launches < 1:
        failed.append("the kernel ran")
    if not res["beta_err"] < MAP_BETA_TOL:
        failed.append("beta against the truth")
    if not r.logpdf >= lp0:
        failed.append("logpdf at the optimum >= at the inits")
    if not res["fused_vs_generic"] < MAP_FUSED_TOL:
        failed.append("fused against generic")
    if not res["warm_start_finite"]:
        failed.append("warm start")
    if failed:
        raise AssertionError(f"map: gates failed: {failed}: {res}")
    return res


def _conjugate_model(mt):
    """tests/test_infer.py's conjugate normal model: (model, y, exact
    posterior mean, sd, log-evidence)."""
    from scipy import stats
    y = np.array([1.1, 0.7, 1.4, 0.9, 1.2, 1.0, 0.8, 1.3])
    model = mt.Model(
        y=mt.Stochastic(1, lambda mu: mt.Normal(mu.expand(8), 1.0),
                        monitor=False),
        mu=mt.Stochastic(lambda: mt.Normal(0.0, np.sqrt(2.0))))
    model.set_samplers([mt.NUTS("mu")])
    v = 1 / (8 + 0.5)
    S = np.eye(8) + 2.0 * np.ones((8, 8))
    return (model, y, v * y.sum(), np.sqrt(v),
            float(stats.multivariate_normal(np.zeros(8), S).logpdf(y)))


def phase_smc(torch, mt, glmm, fg):
    """SMC under the gates of tests/test_infer.py, and on the G = 64 GLMM
    through the kernel's vmap rule over the particles."""
    from mamba_tpu_torch.models import line
    model, y, m_exact, sd_exact, logz = _conjugate_model(mt)
    r = mt.smc(model, {}, {"y": y, "mu": 0.0}, n_particles=SMC_PARTICLES,
               seed=2, device=DEVICE)
    mu = r.particles["mu"]
    conj = {"mean_err": float(abs(mu.mean() - m_exact)),
            "sd_err": float(abs(mu.std() - sd_exact)),
            "log_evidence_err": abs(r.log_evidence - logz), "stages": r.n_stages}
    lmodel, linputs, linits = line.build()
    r = mt.smc(lmodel, linputs, linits[0], n_particles=SMC_PARTICLES,
               rejuvenation_steps=50, seed=3, device=DEVICE)
    b = r.particles["beta"].mean(0)
    line_res = {"beta": b.tolist(), "stages": r.n_stages}
    gmodel, ginputs, ginits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                                mass_window=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fg.glmm_loglik_grads.launches = 0          # count this path only
    r = mt.smc(gmodel, ginputs, ginits[0], n_particles=SMC_GLMM_PARTICLES,
               rejuvenation_steps=SMC_GLMM_STEPS, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    launches = fg.glmm_loglik_grads.launches
    gb = r.particles["beta"].mean(0)
    glmm_res = {"beta": gb.tolist(), "beta_err": float(np.abs(gb - truth["beta"]).max()),
                "log_evidence": r.log_evidence, "stages": r.n_stages,
                "kernel_launches": launches, "smc_s": time.perf_counter() - t0}
    res = {"conjugate": conj, "line": line_res, "glmm": glmm_res}
    log(f"smc ({SMC_PARTICLES} particles; GLMM G=64, {SMC_GLMM_PARTICLES}): "
        + json.dumps(res))
    failed = []
    if not (conj["mean_err"] < 0.03 and conj["sd_err"] < 0.04
            and conj["log_evidence_err"] < 0.3 and conj["stages"] <= 5):
        failed.append("conjugate")
    if not (abs(b[0] - 0.60) < 0.35 and abs(b[1] - 0.80) < 0.12
            and 1 <= line_res["stages"] <= 30):
        failed.append("line")
    if launches < 1:
        failed.append("the kernel ran")
    if not (glmm_res["beta_err"] < SMC_BETA_TOL and np.isfinite(r.log_evidence)):
        failed.append("GLMM beta")
    if failed:
        raise AssertionError(f"smc: gates failed: {failed}: {res}")
    return res


def phase_profile(torch, fg, glmm_cases, kernel_ms):
    """A torch.profiler trace of full-width gradients that names the kernel;
    time_compiled against phase 3's CUDA events; the card's peaks and the
    kernel's bound read from utils/roofline.py."""
    import tempfile
    from mamba_tpu_torch.utils import profiling, roofline
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                 for a in glmm_cases.random_inputs(4, 10, 10_000, 1024, 0))
    fg.glmm_loglik_grads(*args)
    with tempfile.TemporaryDirectory() as tmpdir:
        with profiling.trace(tmpdir) as path:
            for _ in range(PROFILE_GRADIENTS):
                with profiling.annotate("glmm_gradient"):
                    fg.glmm_loglik_grads(*args)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    s = profiling.time_compiled(fg.glmm_loglik_grads, *args, iters=20)
    work = fg.glmm_work(4, 10, 10_000, 1024)
    roof = roofline.roofline(fg.glmm_loglik_grads, *args, flops=work["flops"],
                             bytes=work["bytes"])
    ceiling = roofline.elementwise_ceiling()
    _, clock_max = sm_clocks_mhz()
    name = torch.cuda.get_device_name(0)
    peaks = roofline.device_peaks()
    want = roofline.peaks_for(name)
    bound = fg.glmm_bound_ms(4, 10, 10_000, 1024, 1e6 * clock_max)
    res = {"trace_kernels": kernels,
           "trace_spans": sum(e.get("name") == "glmm_gradient" for e in events),
           "time_compiled_ms": 1e3 * s, "phase3_ms": kernel_ms,
           "roofline": roof, "elementwise_ceiling": ceiling,
           "device_peaks": list(peaks), "bound_ms": bound["bound_ms"],
           "sm_clock_max_mhz": clock_max}
    log("profile: " + json.dumps(res))
    failed = []
    if not any("glmm_reg_kernel" in k for k in kernels):
        failed.append("the trace names glmm_reg_kernel")
    if not abs(1e3 * s - kernel_ms) <= PROFILE_TIME_RTOL * kernel_ms:
        failed.append("time_compiled against phase 3")
    if "H100" not in name or want is None or peaks != (want.fp32_flops,
                                                       want.bytes_per_s):
        failed.append("device_peaks")
    if round(bound["bound_ms"], 4) != 0.0642:
        failed.append("glmm_bound_ms")
    if roof["bound"] == "unknown" or not ceiling["gbytes_s"] > 0:
        failed.append("roofline and the elementwise ceiling")
    if failed:
        raise AssertionError(f"profile: gates failed: {failed}: {res}")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm, rats
    from mamba_tpu_torch.ops import fused_glmm as fg
    from mamba_tpu_torch.samplers import chees, nuts
    from mamba_tpu_torch.scripts import glmm_cases

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        log(f"phase {name}: {walls[name]:.1f} s")
        return out

    card = phase_device(torch)
    timed("build", phase_build, fg)
    cases = timed("kernel", phase_kernels, torch, fg, glmm_cases)
    recovery_sim = timed("glmm_recovery", phase_recovery, mt, glmm)
    glmm_nuts = timed("glmm_nuts", phase_glmm_nuts, torch, mt, glmm, fg, nuts)
    timed("rats_nuts", phase_rats_nuts, torch, mt, rats, nuts)
    _, rats_chees_sim = timed("rats_chees", phase_rats_chees, torch, mt, rats, chees)
    _, zoo_sims = timed("zoo", phase_zoo, torch, mt)
    _, zoo_mv_sims = timed("zoo_mv", phase_zoo_mv, torch, mt)
    glmm_chees, glmm_warm, glmm_tunes = timed(
        "glmm_chees", phase_glmm_chees, torch, mt, glmm, fg, chees)
    mesh_res = timed("mesh", phase_mesh, torch, mt, glmm, fg, chees,
                     glmm_cases, glmm_warm, glmm_tunes)
    del glmm_warm
    timed("post", phase_post, torch, mt, glmm, fg, {**zoo_sims, **zoo_mv_sims},
          rats_chees_sim, recovery_sim)
    del zoo_sims, zoo_mv_sims, rats_chees_sim, recovery_sim
    map_res = timed("map", phase_map, torch, mt, glmm, fg)
    smc_res = timed("smc", phase_smc, torch, mt, glmm, fg)
    timed("profile", phase_profile, torch, fg, glmm_cases, cases[0]["ms"])
    launches = {"glmm_nuts": glmm_nuts["kernel_launches"],
                "glmm_chees": glmm_chees["kernel_launches"],
                "map": map_res["kernel_launches"],
                "smc": smc_res["glmm"]["kernel_launches"],
                "mesh": mesh_res["launches"]}
    log(f"fused kernel launches on the main paths: {json.dumps(launches)}; "
        f"wall ms per leapfrog: NUTS {glmm_nuts['wall_ms_per_leapfrog']:.3f}, "
        f"ChEES {glmm_chees['wall_ms_per_leapfrog']:.3f}")
    log(f"new phases (post, map, smc, profile): "
        f"{sum(walls[k] for k in ('post', 'map', 'smc', 'profile')):.1f} s")
    log(f"phase walls (s): {json.dumps(walls)}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    slice_case = cases[0]
    bound = slice_case["bound"]
    log(f"card: {card}")
    # no single PyTorch call computes lp, grad_beta and grad_b together, so
    # there is no library time.  bound_by says whether bytes or operations
    # set the bound; bound_floor names the floor: "memory", "fp32" or "sfu"
    print(json.dumps({"kernels": [{
        "name": "fused_glmm_loglik_grads", "route": "cuda",
        "source": "mamba_tpu_torch/csrc/fused_glmm.cu",
        "replaces": "mamba_tpu/ops/fused_glmm.py:59",
        "launches": sum(launches.values()),
        "max_abs_err": slice_case["grad_max_abs_err"],
        "lp_rel_err": slice_case["lp_rel_err"],
        "grad_rel_err": slice_case["grad_rel_err"],
        "ms": slice_case["ms"], "plain_ms": slice_case["plain_ms"],
        "bound_ms": bound["bound_ms"],
        "bound_by": "bytes" if bound["bound_by"] == "memory" else "operations",
        "bound_floor": bound["bound_by"],
        "floors_ms": {k[:-3]: v for k, v in bound.items() if k.endswith("_ms")
                      and k != "bound_ms"},
        "pct_of_bound": slice_case["pct_of_bound"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
