"""Flatten/unflatten helpers for dicts of tensors.

Counterpart of the reference's ``unlist``/``relist`` machinery (reference:
src/model/simulation.jl:110-163), which packs node values into a flat
Float64 vector by walking the graph per call.  Here the pack/unpack spec is
computed once at compile time and the runtime path is reshape/concatenate
on one chain's values (the engine batches it over the chain axis with
``torch.func.vmap``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RavelSpec:
    """Static spec for packing a dict of tensors into one flat vector."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    total: int
    dtype: torch.dtype

    def ravel(self, tree: dict[str, torch.Tensor]) -> torch.Tensor:
        if self.total == 0:
            return torch.zeros((0,), dtype=self.dtype)
        parts = [torch.reshape(tree[n], (-1,)).to(self.dtype) for n in self.names]
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def unravel(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        return {n: torch.reshape(flat[off:off + size], shape)
                for n, shape, size, off in zip(self.names, self.shapes,
                                               self.sizes, self.offsets)}


def make_ravel_spec(example: dict, dtype: torch.dtype) -> RavelSpec:
    names = tuple(sorted(example.keys()))
    shapes = tuple(tuple(np.shape(example[n])) for n in names)
    sizes = tuple(int(np.prod(s, dtype=np.int64)) if s else 1 for s in shapes)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes)[:-1])
    return RavelSpec(names=names, shapes=shapes, sizes=sizes,
                     offsets=offsets, total=int(sum(sizes)), dtype=dtype)


def elementwise_names(name: str, shape: tuple[int, ...]) -> list[str]:
    """Flat element names, reference-style: ``beta`` -> ``beta[1]``, ``beta[2]``;
    matrices -> ``S[1,1]`` … (column-major order to match the reference's
    Julia ``vec`` semantics; reference: src/variate.jl:76-88)."""
    if shape == ():
        return [name]
    # Julia vec() flattens column-major; 1-based indices.
    idx = np.indices(shape).reshape(len(shape), -1, order="F") + 1
    return [f"{name}[{','.join(str(i) for i in col)}]" for col in idx.T]
