"""Feeding given numbers into the port's keyed draws, for the sampler parity
tests: ``ops.random.uniform`` and ``ops.random.normal`` hand out the given
arrays in order instead of drawing.  Each array has the draw's full shape,
the keys' batch dims first (one row per chain), then the per-key shape."""

import contextlib

import numpy as np
import torch

from mamba_tpu_torch.ops import random as R


@contextlib.contextmanager
def fed(monkeypatch, rand=(), randn=()):
    """Uniform draws return the arrays of ``rand`` in order, normal draws
    those of ``randn``, each checked against the shape asked for; every
    array must be used.  Yields the queues."""
    queues = {"rand": list(rand), "randn": list(randn)}

    def feeder(kind):
        def draw(key, shape=(), dtype=torch.float32, *a, index=None, **k):
            full = tuple(key.shape[:-1]) + R._out_shape(shape, index)
            assert queues[kind], f"unexpected {kind} draw {full}"
            v = np.asarray(queues[kind].pop(0), dtype=np.float64)
            assert v.shape == full, (kind, v.shape, full)
            return torch.as_tensor(v, dtype=dtype)
        return draw

    with monkeypatch.context() as m:
        m.setattr(R, "uniform", feeder("rand"))
        m.setattr(R, "normal", feeder("randn"))
        yield queues
    assert not queues["rand"] and not queues["randn"], "draws left unused"
