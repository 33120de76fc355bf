"""Node declarations for the hierarchical-model DSL.

Counterpart of the reference's ``Stochastic``/``Logical`` node
constructors (reference: src/model/dependent.jl:75-88, 137-152).  Key design
delta (SURVEY.md §7): nodes here are *declarations only* — pure metadata +
a pure function.  They never carry values; values live in an immutable state
dict threaded through the compiled functions.  Dependencies are extracted
from the node function's parameter names (mirroring the reference's closure
argument-name reflection, src/utils.jl:7-43, but via ``inspect.signature``
instead of compiler introspection).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional


def _argnames(fn: Callable) -> tuple[str, ...]:
    sig = inspect.signature(fn)
    names = []
    for p in sig.parameters.values():
        if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                      inspect.Parameter.KEYWORD_ONLY,
                      inspect.Parameter.POSITIONAL_ONLY):
            names.append(p.name)
    return tuple(names)


@dataclasses.dataclass(frozen=True)
class Node:
    fn: Callable
    dims: int
    #: True/False, or a tuple of 1-based column-major element indices
    #: (reference setmonitor! index vectors, dependent.jl:31-48)
    monitor: object
    deps: tuple[str, ...]
    name: Optional[str] = None  # stamped by Model()

    @property
    def monitored(self) -> bool:
        if isinstance(self.monitor, bool):
            return self.monitor
        return len(self.monitor) > 0

    def monitor_indices(self, size: int):
        """0-based flat (column-major) indices of monitored elements, or
        None for all."""
        if isinstance(self.monitor, bool):
            return None
        idx = sorted(int(i) - 1 for i in self.monitor)
        if any(i < 0 or i >= size for i in idx):
            raise ValueError(
                f"monitor indices out of range for node {self.name!r} "
                f"(size {size})")
        return idx

    @property
    def kind(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StochasticNode(Node):
    """A node whose value is distributed according to ``fn(*parents)``.

    ``fn`` must return a Distribution (possibly with batched parameters —
    the vectorized replacement for the reference's
    ``Array{UnivariateDistribution}`` nodes, distributionstruct.jl:22-79).
    """

    @property
    def kind(self):
        return "stochastic"


@dataclasses.dataclass(frozen=True)
class LogicalNode(Node):
    """A deterministic function node: value = fn(*parents)."""

    @property
    def kind(self):
        return "logical"


def _norm_monitor(monitor):
    if isinstance(monitor, bool):
        return monitor
    return tuple(int(i) for i in monitor)


def Stochastic(dims_or_fn, fn=None, monitor=True) -> StochasticNode:
    """``Stochastic(f)``, ``Stochastic(d, f)``, ``Stochastic(d, f, monitor)``
    — mirrors the reference constructors (dependent.jl:137-152).  ``d`` is the
    array dimensionality of the node's value (0 = scalar)."""
    if callable(dims_or_fn) and fn is None:
        dims, f = 0, dims_or_fn
    elif callable(dims_or_fn):
        # Stochastic(f, monitor) form
        dims, f, monitor = 0, dims_or_fn, fn
    else:
        dims, f = int(dims_or_fn), fn
    return StochasticNode(fn=f, dims=dims, monitor=_norm_monitor(monitor),
                          deps=_argnames(f))


def Logical(dims_or_fn, fn=None, monitor=True) -> LogicalNode:
    """``Logical(f)``, ``Logical(d, f)``, ``Logical(d, f, monitor)``
    (reference: dependent.jl:75-88)."""
    if callable(dims_or_fn) and fn is None:
        dims, f = 0, dims_or_fn
    elif callable(dims_or_fn):
        dims, f, monitor = 0, dims_or_fn, fn
    else:
        dims, f = int(dims_or_fn), fn
    return LogicalNode(fn=f, dims=dims, monitor=_norm_monitor(monitor),
                       deps=_argnames(f))
