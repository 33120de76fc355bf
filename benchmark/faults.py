"""Faults of the samplers' transitions, planted in the program in the
process that asks for them, to read the output check's upper readings
(``python3 -m benchmark.control --fault <name>``) and to see ``correct``
go false (``tests/test_bench_faults.py``).  The benchmark's own runs never
load this module.

- ``always_accept``: ChEES-HMC's Metropolis test accepts every proposal
  (its uniform is 0), as a dropped accept test would;
- ``slice_ignores_energy``: NUTS's slice variable sits 69 nats under the
  start (its uniform is 1e-30), so every leaf of the tree is a candidate
  whatever its energy: the multinomial weighting dropped;
- ``gibbs_rate_doubled``: the rats variances' conjugate draws take twice
  their rate, as where the sums of squares are not halved.
"""

from __future__ import annotations

import contextlib

import torch


class _Shim:
    """A module whose attributes are another's, but those given."""

    def __init__(self, module, **over):
        self._module = module
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _uniform_at(R, fold_hit: int, value: float):
    def uniform(keys, shape=(), dtype=torch.float32, *a, fold=None, **kw):
        u = R.uniform(keys, shape, dtype, *a, fold=fold, **kw)
        return torch.full_like(u, value) if fold == fold_hit else u
    return uniform


def _patched(module, name, new):
    old = getattr(module, name)
    setattr(module, name, new)
    return lambda: setattr(module, name, old)


def _always_accept():
    from mamba_tpu_torch.samplers import chees
    return _patched(chees, "R", _Shim(chees.R, uniform=_uniform_at(chees.R, 1, 0.0)))


def _slice_ignores_energy():
    from mamba_tpu_torch.samplers import nuts
    return _patched(nuts, "R", _Shim(nuts.R, uniform=_uniform_at(nuts.R, 1, 1e-30)))


def _gibbs_rate_doubled():
    from mamba_tpu_torch.models import rats
    R = rats.R

    def inverse_gamma_bounded(keys, a, b, *args, **kw):
        return R.inverse_gamma_bounded(keys, a, 2.0 * b, *args, **kw)
    return _patched(rats, "R", _Shim(R, inverse_gamma_bounded=inverse_gamma_bounded))


FAULTS = {"always_accept": _always_accept,
          "slice_ignores_energy": _slice_ignores_energy,
          "gibbs_rate_doubled": _gibbs_rate_doubled}


@contextlib.contextmanager
def planted(name: str | None):
    """The fault ``name`` (None: none) planted for the ``with`` body."""
    undo = FAULTS[name]() if name else (lambda: None)
    try:
        yield
    finally:
        undo()
