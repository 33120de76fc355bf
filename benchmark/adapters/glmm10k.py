"""The non-centered GLMM of ``mamba_tpu_torch.models.glmm`` on the
benchmark's data: ``likelihood`` "fused" (the hand-written kernel, x as
(P, n, G) and y as (n, G)) or "generic" (the compiler's autograd ops, x as
(G, n, P) and y as (G, n))."""

from __future__ import annotations

import numpy as np


def build(config: dict, data: dict, likelihood: str):
    from mamba_tpu_torch.models import glmm
    if likelihood not in ("fused", "generic"):
        raise ValueError(f"GLMM likelihood {likelihood!r}")
    fused = likelihood == "fused"
    G, n = config["G"], config["n"]
    model, inputs, inits, _ = glmm.build(G=G, n=n, seed=0, fused=fused)
    x, y = data["x"], data["y"]
    if fused:
        inputs_b = {"xt": np.ascontiguousarray(x.transpose(2, 1, 0))}
        y = np.ascontiguousarray(y.T)
    else:
        inputs_b = {"x": x}
    if ({k: np.shape(v) for k, v in inputs.items()}
            != {k: v.shape for k, v in inputs_b.items()}
            or np.shape(inits[0]["y"]) != y.shape):
        raise ValueError("glmm.build's inputs are not laid out as the "
                         "benchmark's data")
    return model, inputs_b, [dict(inits[0], y=y)], glmm
