"""Utilities: ravel specs, math helpers, progress meter, numpy conversion,
profiling and roofline tools."""

from .pytree import RavelSpec, elementwise_names, make_ravel_spec
from . import profiling

__all__ = ["RavelSpec", "make_ravel_spec", "elementwise_names", "profiling"]
