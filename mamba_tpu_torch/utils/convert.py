"""Carry numpy trees — inputs, chain-stacked states and NUTS tunes exported
from another implementation of the same model — into this package's tensors
on a given device, so both can be evaluated at the same state."""

from __future__ import annotations

import numpy as np
import torch

from ..samplers.nuts import NUTSTune


def to_tensor(v, device, dtype: torch.dtype) -> torch.Tensor:
    """A numpy value as a tensor: floating values in ``dtype``, integer and
    boolean values keep their kind."""
    a = np.asarray(v)
    return torch.as_tensor(
        a, dtype=dtype if np.issubdtype(a.dtype, np.floating) else None,
        device=device)


def to_tensors(tree: dict, device, dtype: torch.dtype) -> dict:
    """``{name: numpy value}`` -> ``{name: tensor}``."""
    return {k: to_tensor(v, device, dtype) for k, v in tree.items()}


def nuts_tune(tune, device, dtype: torch.dtype) -> NUTSTune:
    """A NUTS tune with numpy fields (a NamedTuple or a mapping of the
    same field names; ``adapted`` may be absent) -> ``NUTSTune``.  Without
    an ``adapted`` field, adaptation counts as having run once the averaged
    step has left its initial 1.0, the other implementation's test."""
    fields = dict(tune._asdict() if hasattr(tune, "_asdict") else tune)
    if "adapted" not in fields:
        fields["adapted"] = np.asarray(fields["epsilonbar"]) != 1.0
    return NUTSTune(**{k: to_tensor(fields[k], device, dtype)
                       for k in NUTSTune._fields})
