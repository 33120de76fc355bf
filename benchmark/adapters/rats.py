"""The rats model of ``mamba_tpu_torch.models.rats`` on the benchmark's copy
of the published data."""

from __future__ import annotations

import numpy as np


def build(config: dict, data: dict, likelihood=None):
    from mamba_tpu_torch.models import rats
    model, inputs, inits = rats.build("nuts")
    if set(inputs) != {"Xm", "xbar"} or np.shape(inits[0]["y"]) != data["y"].shape:
        raise ValueError(f"rats.build's inputs {sorted(inputs)} and y "
                         f"{np.shape(inits[0]['y'])} are not the configuration's")
    xbar = float(np.mean(data["x"]))
    inputs = {"Xm": data["x"] - xbar, "xbar": xbar}
    inits = [dict(d, y=data["y"]) for d in inits]
    return model, inputs, inits, rats
