"""The leapfrog steps of ChEES-HMC's trajectories: the algorithm's
gradient evaluations, whatever the implementation captures or fuses.

A trajectory of iteration ``it`` runs L = clip(ceil(h * T / eps), 1,
max_steps) leapfrog steps, h the base-2 Halton jitter of ``it``, T the
trajectory length and eps the step size (after the warm-up, the
dual-averaged one); each step is one gradient, and the gradient at the
start is the previous state's, so a trajectory needs L.  Frozen copy of
``mamba_tpu_torch/samplers/chees.py``'s ``_halton2`` and ``_steps`` at
commit fc13fd826c36831480dadd26fb8e0f34af6cabfa, in the tensors' dtype as
there.
"""

from __future__ import annotations

import torch


def halton2(m: int) -> float:
    """Base-2 Halton value of ``m``: its low 16 bits reversed into [0, 1)."""
    return sum(0.5 ** (k + 1) for k in range(16) if (m >> k) & 1)


def steps(it: int, traj, eps, max_steps: int) -> int:
    """L of the trajectory of iteration ``it``."""
    v = float(torch.ceil(halton2(it) * traj / eps))
    return int(min(max(v, 1.0), float(max_steps)))


def window_steps(tune, iters: int) -> int | None:
    """The leapfrog steps of the last ``iters`` iterations after the
    warm-up, from a ChEES tune as ``mcmc``'s ``states["tunes"]`` holds it
    (its ``it``, ``traj``, ``epsilonbar`` and ``max_steps``); None for a
    tune that has none."""
    try:
        it, traj, eps, cap = tune.it, tune.traj, tune.epsilonbar, tune.max_steps
    except AttributeError:
        return None
    return sum(steps(i, traj, eps, cap) for i in range(it - iters, it))
