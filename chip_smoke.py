#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit.  It builds the fused GLMM kernel from ``mamba_tpu_torch/csrc``,
holds it against its plain torch version, and drives the port's main path
— ``glmm.build(fused=True)`` sampled by NUTS through ``mcmc`` — first small
enough to check posterior recovery, then at full width (10,000 groups,
1,024 chains).  Every phase raises on failure.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it lists each
kernel with its launches on the main path, its error and its time.  With no
CUDA device the script exits with status 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: phase-3 shapes (C chains, G groups); n = 10 observations, P = 4 effects
KERNEL_CASES = ((1024, 10_000), (1000, 9_999), (1, 37))
#: lp relative error: a sum of 100k negative terms has no cancellation
LP_RTOL = 1e-5
#: gradient error max|d| / max|g_ref| over (grad_beta, grad_b): every
#: contraction is float32 FMA
GRAD_RTOL = 1e-4


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


def phase_build(fg):
    t0 = time.perf_counter()
    fg.build_library()
    fg._lib()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for line in (fg.BUILD_DIR / "fused_glmm.build.log").read_text().splitlines():
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


def kernel_case(torch, fg, C, G, n=10, P=4, seed=0, time_reps=0):
    """Kernel (float32) against the plain version in float64 on the same
    inputs; returns the errors and, with ``time_reps``, ms per call of the
    kernel and of the float32 plain version."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device="cuda")
    Xt = torch.as_tensor(rng.normal(0, 1, (P, n, G)), **f32)
    y = torch.as_tensor((rng.random((n, G)) < 0.5).astype(np.float64), **f32)
    betas = torch.as_tensor(rng.normal(0, 0.5, (C, P)), **f32)
    bs = torch.as_tensor(rng.normal(0, 0.7, (C, G)), **f32)
    args = (Xt, y, betas, bs)
    lp, gbeta, gb = fg.glmm_loglik_grads(*args)
    torch.cuda.synchronize()
    lp_r, gbeta_r, gb_r = fg.glmm_loglik_grads_plain(*(a.double() for a in args))
    lp_err = ((lp.double() - lp_r).abs() / lp_r.abs()).max().item()
    gmax = max(gbeta_r.abs().max().item(), gb_r.abs().max().item())
    gabs = max((gbeta.double() - gbeta_r).abs().max().item(),
               (gb.double() - gb_r).abs().max().item())
    out = {"C": C, "G": G, "lp_rel_err": lp_err, "grad_rel_err": gabs / gmax,
           "grad_max_abs_err": gabs}
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
        out.update(us_per_call=out["ms"] * 1e3,
                   plain_us_per_call=out["plain_ms"] * 1e3)
    log("kernel vs plain: " + json.dumps(out))
    if not (out["lp_rel_err"] <= LP_RTOL and out["grad_rel_err"] <= GRAD_RTOL):
        raise AssertionError(f"fused GLMM kernel disagrees with its plain "
                             f"version at C={C}, G={G}: {out}")
    if not out["reproducible"]:
        raise AssertionError(f"fused GLMM kernel is not reproducible at C={C}, G={G}")
    return out


def phase_kernels(torch, fg):
    return [kernel_case(torch, fg, C, G, time_reps=20 if i == 0 else 0)
            for i, (C, G) in enumerate(KERNEL_CASES)]


def _record_depths(nuts):
    """Wrap ``nuts_sub`` to observe every transition's per-chain tree depth
    (the smoke test's own instrument; the sampler is unchanged)."""
    depths = []
    inner = nuts.nuts_sub

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        depths.append(out[3].detach().cpu())
        return out

    nuts.nuts_sub = recording
    return depths, lambda: setattr(nuts, "nuts_sub", inner)


def phase_recovery(mt, glmm):
    model, inputs, inits, truth = glmm.build(G=64, n=10, seed=2, fused=True,
                                             mass_window=50)
    sim = mt.mcmc(model, inputs, inits, 400, burnin=150, chains=4,
                  verbose=False, device="cuda")
    s = mt.summarystats(sim).to_dict()
    est = np.array([s[f"beta[{i + 1}]"]["Mean"] for i in range(4)])
    err = float(np.abs(est - truth["beta"]).max())
    log(f"recovery (G=64, 4 chains, 400 iters): beta means {est.round(4).tolist()}"
        f" vs truth {truth['beta'].tolist()}, max error {err:.4f}; "
        f"sample_s {sim.timing['sample_s']:.2f}")
    if not err < 0.35:
        raise AssertionError(f"beta not recovered: max error {err}")


def phase_full_width(torch, mt, glmm, fg, nuts):
    iters, burnin, chains = 30, 10, 1024
    model, inputs, inits, _ = glmm.build(G=10_000, n=10, seed=0, fused=True)
    depths, restore = _record_depths(nuts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fg.glmm_loglik_grads.launches = 0          # count the main path only
    try:
        sim = mt.mcmc(model, inputs, inits, iters, burnin=burnin,
                      chains=chains, verbose=False, device="cuda")
    finally:
        restore()
    launches = fg.glmm_loglik_grads.launches
    d = torch.stack(depths)                    # (iterations, chains)
    # all chains step in lockstep, so an iteration evaluates the deepest
    # chain's 2**depth - 1 leapfrog steps
    leapfrogs = int((2 ** d.max(dim=1).values.long() - 1).sum())
    t = sim.timing
    res = {"setup_s": t["setup_s"], "sample_s": t["sample_s"],
           "fetch_s": t["fetch_s"],
           "chain_iters_per_s": chains * iters / t["sample_s"],
           "mean_tree_depth": float(d.float().mean()),
           "max_tree_depth": int(d.max()), "leapfrog_steps": leapfrogs,
           "kernel_launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("full width (G=10000, n=10, P=4, 1024 chains, 30 iters, 10 burnin): "
        + json.dumps(res))
    v = sim.value
    if v.shape != (iters - burnin, 5, chains) or not np.isfinite(v).all():
        raise AssertionError(f"kept draws: shape {v.shape}, finite "
                             f"{np.isfinite(v).all()}")
    s2 = v[:, sim.names.index("s2"), :]
    if not (s2 > 0).all():
        raise AssertionError("s2 left its support")
    if launches < leapfrogs or launches == 0:
        raise AssertionError(f"the fused kernel ran {launches} times for "
                             f"{leapfrogs} leapfrog steps")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import mamba_tpu_torch as mt
    from mamba_tpu_torch.models import glmm
    from mamba_tpu_torch.ops import fused_glmm as fg
    from mamba_tpu_torch.samplers import nuts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device(torch)
    phase_build(fg)
    cases = phase_kernels(torch, fg)
    phase_recovery(mt, glmm)
    full = phase_full_width(torch, mt, glmm, fg, nuts)
    slice_case = cases[0]
    log(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "fused_glmm_loglik_grads", "route": "cuda",
        "source": "mamba_tpu_torch/csrc/fused_glmm.cu",
        "replaces": "mamba_tpu/ops/fused_glmm.py:59",
        "launches": full["kernel_launches"],
        "max_abs_err": slice_case["grad_max_abs_err"],
        "lp_rel_err": slice_case["lp_rel_err"],
        "grad_rel_err": slice_case["grad_rel_err"],
        "ms": slice_case["ms"], "plain_ms": slice_case["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
