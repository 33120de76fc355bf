"""Run progress meter with ETA (reference src/progress.jl:5-65).

The reference prints a per-chain meter at 10% increments with elapsed /
remaining estimates (ChainProgressFrame/ChainProgress, wired at
src/model/mcmc.jl:44-51,73-80).  Chains here run in lockstep on one chain axis —
one meter covers all of them — but the default-on ETA UX is preserved:
the engine updates the meter every iteration and a line is
emitted whenever progress crosses a 10% step.
"""

from __future__ import annotations

import sys
import time

__all__ = ["ChainProgress"]


def _fmt(seconds: float) -> str:
    seconds = max(0, int(round(seconds)))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h}:{m:02d}:{s:02d}"


class ChainProgress:
    """Meter over ``total`` iterations printed at ``step`` increments
    (reference ChainProgress, progress.jl:19-33; output format mirrors
    progress.jl:48-59)."""

    def __init__(self, total: int, *, chains: int = 1, step: float = 0.10,
                 label: str = "MCMC Simulation", stream=None):
        self.total = max(int(total), 1)
        self.chains = chains
        self.step = step
        self.label = label
        self.stream = stream or sys.stdout
        self.reset()

    def reset(self):
        """(reference reset!, progress.jl:35-39)"""
        self.done = 0
        self.t0 = time.time()
        self._next = self.step
        print(f"{self.label} of {self.total} Iterations x {self.chains} "
              f"Chains...\n", file=self.stream, flush=True)
        return self

    def update(self, n: int = 1):
        """Advance by ``n`` iterations; print when a step boundary is
        crossed (reference next!, progress.jl:41-59)."""
        self.done += n
        frac = self.done / self.total
        if frac + 1e-12 >= self._next or self.done >= self.total:
            elapsed = time.time() - self.t0
            remaining = elapsed * (self.total - self.done) / max(self.done, 1)
            print(f"  {100 * frac:3.0f}% [{_fmt(remaining)} of "
                  f"{_fmt(elapsed + remaining)} remaining]",
                  file=self.stream, flush=True)
            while self._next <= frac + 1e-12:
                self._next += self.step
        return self
