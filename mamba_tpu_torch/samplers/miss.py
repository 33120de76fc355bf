"""Missing-value imputation sampler (reference src/samplers/miss.jl).

NaN entries of an observed node's init values mark missingness.  The
reference scans for NaNs at iteration 1 (miss.jl:44-52); here the mask is
resolved once at build time from the compiled model's example values and
every step redraws exactly those entries, for every chain, from the node's
current predictive distribution — one masked ``torch.where`` per site instead
of the reference's per-index loops (miss.jl:70-86).

The engine's chain initializer prior-imputes NaN inits before the first
iteration — the reference gets the same effect because MISS runs inside
iteration 1 before any likelihood-consuming block touches the node.

Random draws per step: one ``forward_sample`` of each masked site, in the
order of ``params``.  The step is one body (``utils.graphs.Captured``),
which the engine replays from a CUDA graph: the draws are made inside it,
from the block's per-chain keys, which the step loads into the buffer
``key`` (one key split off per site), so that a replay draws the numbers
the body run eagerly draws; the plain loop runs the same body eagerly.  On a mesh's
data axis the draw is made at the site's whole shape (``forward_sample``),
so every data rank takes the unsharded run's stream and keeps its slice:
the all-gathers of the site's parameters cut the captured body
(``utils.graphs.cut``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import random as R
from ..utils import graphs
from .base import BlockKernel, SamplerSpec, drawing


def missing_masks(cm, params) -> dict[str, np.ndarray]:
    """NaN masks of the given observed sites (empty-mask sites are dropped,
    mirroring miss.jl:47-49)."""
    masks = {}
    for name in params:
        m = np.isnan(cm.example_values[name])
        if m.any():
            masks[name] = m
    return masks


class MISS(SamplerSpec):
    """MISS(params) — imputation block for observed nodes with NaN entries
    (reference MISS ctor, miss.jl:41-62)."""

    transform = False
    #: its sites hold data: on a mesh's data axis a rank holds its slice
    #: of them, in the state too (``model/compile.py``)
    imputes_data = True

    def build(self, cm) -> BlockKernel:
        # which sites have missing values comes from the whole value, so
        # every data rank draws the same sites from the stream; each
        # redraws the entries of its slice
        masks = {n: torch.as_tensor(cm.local(n, m), device=cm.device)
                 for n, m in missing_masks(cm, self.params).items()}

        cap = drawing(impute_bodies(cm, masks),
                      eager=not graphs.enabled())

        def init(key, state):
            return ()

        def step(key, state, tune, adapt):
            if not masks:
                return state, tune
            cap.load_state(state)
            cap.load(key=key)
            for name in masks:
                if not cap.holds(name, state[name]):
                    cap.load(**{name: state[name]})
            cap.run()
            return {**state, **{n: cap.bufs[n].clone() for n in masks}}, tune

        return BlockKernel(init, step)


def _impute(cm, masks, b, state):
    """Each masked site redrawn where its mask is set, in order, from its
    predictive distribution at the state as it stands, with a key split
    off ``b["key"]`` per site; written to ``b[site]``."""
    state = dict(state)
    for (name, mask), key in zip(masks.items(), R.split(b["key"], len(masks))):
        draw = cm.forward_sample(key, state, names=(name,))[name]
        state[name] = torch.where(mask, draw, state[name])
        b[name].copy_(state[name])


def impute_bodies(cm, masks):
    """MISS's step on the compiled model ``cm``, drawing from the keys in
    its buffer ``key``."""
    return {"body": lambda b, s: _impute(cm, masks, b, s)}
