"""How ``correct`` is decided: the window's outputs against the plain
reference of the cell's configuration.

The numbers compared, each against its limit in the cell's traffic file
(``score_z`` and ``stein_z`` where the cell's limits name them):

- ``lp_gap``: the widest relative gap, over every chain's final state, of
  the block log-density that the window's sampler steps evaluate (the
  program's ``block_density`` of the run's own compiled model, at full
  width and all chains) from the reference's, in float64 at the same
  flat coordinates;
- ``grad_gap``: the widest gap of its gradient, per chain and site, over
  the larger of the reference's largest component of that site and the
  median site's (some sites' gradients are all but zero);
- ``draw_gap``: the widest relative gap of the window's last kept draw of
  each monitored scalar from the reference's, worked out again from the
  final state;
- ``unmoved``: the chains whose gradient-block sites end the window where
  they started it (exact, limit 0);
- ``score_z``: whether the window's transitions leave the posterior where
  it was.  At stationarity every coordinate j of the gradient block has
  E[g_j] = 0 and E[(x_j - m_j) g_j] = -1 (Stein's identities; g the
  reference's float64 gradient of the block's log-density, which is the
  joint's, m_j any constant).  Over the 1024 independent chains' final
  states, each identity gives each coordinate a t statistic; a site's
  mean t^2 is 1 under a sound sampler, with a spread of sqrt(2/d) over
  its d coordinates.  The number is the largest excess (mean t^2 - 1) /
  sqrt(2/d) over the sites and the two identities: a dropped accept test
  or a biased trajectory moves it, a correct density does not hide it;
- ``stein_z``: the second identity summed over each site's coordinates,
  chain by chain: T_c = sum_j ((x_cj - xbar_j) g_cj C / (C - 1) + 1), whose
  mean over the chains is 0 under a sound sampler (the factor undoes the
  1/C that the chains' own mean xbar takes).  The number is the largest
  |t| of that mean over the sites.  A transition that is off by a little
  in every coordinate, as a dropped accept test is at a step size tuned
  for thousands of coordinates, moves every term the same way: the sum
  sees it where ``score_z``'s squares, which grow with its square, do not;
- ``gibbs_ks`` (configurations whose reference gives ``gibbs_pit``): the
  Kolmogorov distance, times sqrt(chains), of each Gibbs-drawn site's
  final values, as probability-integral transforms under the reference's
  float64 conditional given the final state, from the uniform; the worst
  site.  A Gibbs block draws last in its iteration, so each transform is
  exactly uniform and independent across chains under a sound block.

``failed`` counts the window's kept chain-iterations with a monitored
draw that is not finite or outside its support, and has to be 0.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


class ProgramSide:
    """What the program produced: read from the run after the window, then
    held on the host so that the program's state can be freed."""

    def __init__(self, sim, params, sites, start: dict, labels,
                 draws: np.ndarray):
        cm = sim.compiled
        state = sim.states["state"]
        spec = cm.block_functions(params, True)[2]
        vpack = cm.block_maps(params, True)[0]
        density = cm.block_density(params, True, grad=True)
        x = vpack(state)
        lp, g = density(x, state)
        self.lp = _np(lp)
        self.parts = {n: _np(x[:, o:o + s]) for n, o, s in
                      zip(spec.names, spec.offsets, spec.sizes)}
        self.grads = {n: _np(g[:, o:o + s]) for n, o, s in
                      zip(spec.names, spec.offsets, spec.sizes)}
        self.values = {n: _np(state[n]) for n in sites}
        moved = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for n in params:
            a, b = start[n], state[n]
            moved |= (a != b).reshape(a.shape[0], -1).any(dim=1)
        self.unmoved = int((~moved).sum())
        self.labels = list(labels)
        self.last = {l: draws[-1, i].astype(np.float64)
                     for i, l in enumerate(self.labels)}


def attempted_failed(reference, labels, draws: np.ndarray) -> tuple[int, int]:
    """Kept chain-iterations of the window, and those with a monitored
    draw not finite or outside its support."""
    ok = np.ones((draws.shape[0], draws.shape[2]), dtype=bool)
    for i, l in enumerate(labels):
        ok &= reference.in_support(l, draws[:, i, :])
    return int(ok.size), int((~ok).sum())


def reference_side(reference, data, prog: ProgramSide, dtype, device,
                   block: int):
    """The reference's log-density, gradient and monitored scalars at the
    program's final states, in ``dtype``, in blocks of ``block`` chains,
    as float64 host arrays."""
    # a reference matmul is never TF32 (float64 and bfloat16 are not, but a
    # float32 reference would be where these allow it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C = prog.lp.shape[0]
    lps, grads = [], {n: [] for n in prog.grads}
    for lo in range(0, C, block):
        sl = slice(lo, min(C, lo + block))
        lp, g = reference.block_logp_grad(
            data, {n: v[sl] for n, v in prog.parts.items()},
            {n: prog.values[n][sl] for n in reference.STATE_SITES},
            dtype, device)
        lps.append(_np(lp))
        for n in grads:
            grads[n].append(_np(g[n]).reshape(lp.shape[0], -1))
    mon = reference.monitored(
        data, {n: prog.values[n] for n in reference.STATE_SITES}, dtype,
        device)
    return (np.concatenate(lps), {n: np.concatenate(v) for n, v in grads.items()},
            {l: _np(v) for l, v in mon.items()})


def score_z(parts: dict, grads: dict) -> float:
    """The worst excess of a site's mean t^2 over the two Stein identities
    (module docstring), from the flat coordinates ``parts`` and the
    reference's gradient ``grads`` at them ({site: (C, d)}, float64)."""
    worst = -np.inf
    for n, g in grads.items():
        x = parts[n].reshape(g.shape)
        C, d = g.shape
        for s in (g, (x - x.mean(axis=0)) * g + 1.0):
            sd = s.std(axis=0, ddof=1)
            t = np.where(sd > 0, s.mean(axis=0) / np.where(sd > 0, sd, 1.0)
                         * math.sqrt(C), 0.0)
            worst = max(worst, (float(np.mean(t * t)) - 1.0) / math.sqrt(2.0 / d))
    return float(worst)


def stein_z(parts: dict, grads: dict) -> float:
    """The largest |t| over the sites of the second Stein identity summed
    over the site's coordinates, chain by chain (module docstring)."""
    worst = 0.0
    for n, g in grads.items():
        x = parts[n].reshape(g.shape)
        C = g.shape[0]
        T = ((x - x.mean(axis=0)) * g * (C / (C - 1.0)) + 1.0).sum(axis=1)
        sd = T.std(ddof=1)
        if sd > 0:
            worst = max(worst, abs(float(T.mean() / sd * math.sqrt(C))))
    return worst


def ks_uniform(u: np.ndarray) -> float:
    """sqrt(n) times the Kolmogorov distance of the sample ``u`` from the
    uniform on [0, 1]."""
    u = np.sort(np.asarray(u, dtype=np.float64).ravel())
    n = u.size
    i = np.arange(1, n + 1)
    return float(math.sqrt(n) * max(np.max(i / n - u), np.max(u - (i - 1) / n)))


def gibbs_ks(reference, data, prog: "ProgramSide") -> float | None:
    """``gibbs_ks`` of the final state, or None where the configuration
    has no Gibbs block."""
    pit = getattr(reference, "gibbs_pit", None)
    if pit is None:
        return None
    return max(ks_uniform(u) for u in pit(data, prog.parts, prog.values).values())


def gaps(lp, grads, mon, ref) -> dict:
    """``lp_gap``, ``grad_gap`` and ``draw_gap`` of (lp, grads, monitored)
    against the float64 reference ``ref`` = (lp, grads, monitored)."""
    r_lp, r_g, r_mon = ref
    lp_gap = np.max(np.abs(lp - r_lp) / np.maximum(np.abs(r_lp), 1.0))
    scale = np.stack([np.max(np.abs(r_g[n]), axis=1) for n in r_g], axis=1)
    floor = np.median(scale, axis=1)
    grad_gap = max(np.max(np.max(np.abs(grads[n] - r_g[n]), axis=1)
                          / np.maximum(np.maximum(scale[:, i], floor), 1e-30))
                   for i, n in enumerate(r_g))
    draw_gap = max(np.max(np.abs(mon[l] - r_mon[l])
                          / np.where(r_mon[l] != 0, np.abs(r_mon[l]), 1.0))
                   for l in r_mon)
    return {"lp_gap": float(lp_gap), "grad_gap": float(grad_gap),
            "draw_gap": float(draw_gap)}


def judge(reference, data, prog: ProgramSide, limits: dict, device,
          block: int) -> tuple[bool, dict]:
    """Every number compared beside its limit, and whether each is within
    it (NaN is not)."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_side(reference, data, prog, torch.float64, device, block)
    nums = gaps(prog.lp, prog.grads, prog.last, ref)
    nums["unmoved"] = prog.unmoved
    # the transitions' numbers that the cell's limits name: each where it
    # separates a sound run from a planted fault at the cell's size
    if "score_z" in limits:
        nums["score_z"] = score_z(prog.parts, ref[1])
    if "stein_z" in limits:
        nums["stein_z"] = stein_z(prog.parts, ref[1])
    ks = gibbs_ks(reference, data, prog)
    if ks is not None:
        nums["gibbs_ks"] = ks
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
