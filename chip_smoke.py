#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit.  It drives every arm of the JAX package's ``bench.py`` through the
port's public entry points (``mcmc``, ``advi``, ``summarystats``,
``rhat_rank``, ``ess_bulk``), in these phases:

1. device: the card's name, power limit and SM clocks;
2. build: ``mamba_tpu_torch/csrc/fused_glmm.cu`` with nvcc (sm_90a);
3. kernel: the fused GLMM kernel against its plain torch version in five
   cases (``KERNEL_CASES``): full width, where both are timed; a ragged
   edge; one chain; a shape that takes the generic kernel; and full width
   near a posterior mode, where ``grad_beta`` cancels;
4. GLMM recovery: ``glmm.build(G=64, fused=True)`` under NUTS, 4 chains;
5. GLMM NUTS at full width: G = 10,000, 1024 chains, a short run;
6. rats NUTS, the bench's headline: ``rats.build("nuts")``, 1024 chains,
   cut from 1500 to 100 iterations (50 burnin), gated on the golden
   mu_beta mean (rank R-hat and bulk ESS printed; they are gated only for
   runs of 500 kept draws or more);
7. rats ChEES: ADVI warm start, then ChEES-HMC with the conjugate Gibbs
   block, 1024 chains x 1500 iterations (500 burnin), gated on the golden
   mu_beta mean, rank R-hat < 1.01 and bulk ESS > 400;
8. GLMM ChEES at full width: ADVI on the generic build, then ChEES-HMC
   through the fused kernel, 1024 chains, a short run.

The GLMM phases 5 and 8 each set the kernel's launch count to 0 just before
they run and read it just after.  Every phase raises on failure.  The whole
run takes 8 to 14 minutes on an H100, 5 to 9 of them in the rats NUTS phase
and 1 to 2 in rats ChEES.  The paths are host-bound, so the time follows the
host's CPU.  The last line of standard output is ``{"ok": true, "device": {...}}``;
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
import subprocess
import sys
import time

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
#: leapfrog costs 5 to 9 ms of host time, by the host's load, so these 100
#: iterations (60,668 leapfrogs) take 5 to 9 minutes
RATS_NUTS_RUN = (100, 50)
#: rats ChEES (phase 7), bench.py:63-98
RATS_CHEES_RUN = (1500, 500)
#: GLMM ChEES at full width (phase 8); depth cut from bench.py's 1300/300
GLMM_CHEES_RUN = (20, 10)
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


def phase_recovery(mt, glmm):
    model, inputs, inits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                             mass_window=50)
    sim = mt.mcmc(model, inputs, inits, 400, burnin=150, chains=4,
                  verbose=False, device=DEVICE)
    s = mt.summarystats(sim).to_dict()
    est = np.array([s[f"beta[{i + 1}]"]["Mean"] for i in range(4)])
    err = float(np.abs(est - truth["beta"]).max())
    log(f"recovery (G=64, 4 chains, 400 iters): beta means {est.round(4).tolist()}"
        f" vs truth {truth['beta'].tolist()}, max error {err:.4f}; "
        f"sample_s {sim.timing['sample_s']:.2f}")
    if not err < 0.35:
        raise AssertionError(f"beta not recovered: max error {err}")


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
    return res


def phase_glmm_chees(torch, mt, glmm, fg, chees):
    iters, burnin = GLMM_CHEES_RUN
    model, inputs, inits, _ = glmm.build(10_000, fused=True)
    model_g, inputs_g, inits_g, _ = glmm.build(10_000, fused=False)
    # ADVI on the generic build (same posterior, same sites), as bench.py
    warm, advi_s = _advi_warm_inits(torch, mt, model_g, inputs_g, inits_g[0],
                                    1000, CHAINS)
    warm = [dict(inits[0], **{k: w[k] for k in ("beta", "z", "s2")})
            for w in warm]
    model = _chees_block(mt, model, max_steps=256, mass_window=40)
    steps, restore = _recording(chees, "_steps", lambda L: L)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fg.glmm_loglik_grads.launches = 0          # count this path only
    try:
        sim = mt.mcmc(model, inputs, warm, iters, burnin=burnin,
                      chains=CHAINS, verbose=False, device=DEVICE)
    finally:
        restore()
    launches = fg.glmm_loglik_grads.launches
    need = sum(L + 1 for L in steps)           # logfgrad at x, then L steps
    res = {**_timing(sim, CHAINS, iters), "advi_s": advi_s,
           "steps_per_iteration": steps, "leapfrog_steps": sum(steps),
           "kernel_launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["wall_ms_per_leapfrog"] = 1e3 * res["sample_s"] / res["leapfrog_steps"]
    res["wall_ms_per_gradient"] = 1e3 * res["sample_s"] / need
    log(f"GLMM ChEES at full width (G=10000, {CHAINS} chains, {iters} iters, "
        f"{burnin} burnin): " + json.dumps(res))
    _check_glmm_draws(sim, iters, burnin, CHAINS)
    if launches < need or launches == 0:
        raise AssertionError(f"the fused kernel ran {launches} times for "
                             f"{need} gradient evaluations")
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
    timed("glmm_recovery", phase_recovery, mt, glmm)
    glmm_nuts = timed("glmm_nuts", phase_glmm_nuts, torch, mt, glmm, fg, nuts)
    timed("rats_nuts", phase_rats_nuts, torch, mt, rats, nuts)
    timed("rats_chees", phase_rats_chees, torch, mt, rats, chees)
    glmm_chees = timed("glmm_chees", phase_glmm_chees, torch, mt, glmm, fg, chees)
    log(f"fused kernel launches: GLMM NUTS {glmm_nuts['kernel_launches']}, "
        f"GLMM ChEES {glmm_chees['kernel_launches']}; wall ms per leapfrog: "
        f"NUTS {glmm_nuts['wall_ms_per_leapfrog']:.3f}, "
        f"ChEES {glmm_chees['wall_ms_per_leapfrog']:.3f}")
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
        "launches": glmm_nuts["kernel_launches"] + glmm_chees["kernel_launches"],
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
    sys.exit(main())
