"""The card's captured steps emulated on the CPU: ``Captured._capture``
with stand-ins for CUDA graphs, which warm a body up, record it (its
launches to its segments' tallies, its collectives cut and not issued) and
replay it by running it eagerly, its segments one after another with the
capture's cuts between them.  Imports torch and the port alone, so that a
test's rank processes start without JAX."""

import torch

from mamba_tpu_torch.utils import graphs


class _FakeGraph:
    """Stands in for a captured CUDA graph of one segment: its replay is
    the part of the body's eager run up to the next collective
    (``_FakeProgram``)."""

    def replay(self):
        pass


class _Replaying(graphs._Recording):
    """The launch tally of an emulated replay (the launches count from the
    capture's tallies, as a replay's do), which meets the capture's cuts in
    turn: each collective is checked against the one recorded there, its
    input copied to the cut's input, and the cut run, as between two
    segments' replays; the body reads the cut's output."""

    def __init__(self, cuts):
        super().__init__(None, None)
        self.recorded, self.at = cuts, 0

    def cut(self, kind, inp, make, group=()):
        if self.at == len(self.recorded):
            raise RuntimeError(f"a {kind} the capture did not record")
        c = self.recorded[self.at]
        self.at += 1
        have, want = (graphs._signature(kind, inp, group),
                      graphs._signature(c.kind, c.inp, c.group))
        if have != want:
            raise RuntimeError(f"a captured body's collective changed: "
                               f"{have} where the capture recorded {want}")
        c.inp.copy_(inp)
        c.run()
        return c.out


class _FakeProgram(graphs.Program):
    """A captured body on the CPU: its replay runs the body eagerly, its
    segments one after another, with the capture's cuts between them."""

    def __init__(self, cap, body, rec, out):
        super().__init__(rec.segments, rec.cuts, out)
        self.cap, self.body = cap, body

    def replay(self):
        rep = _Replaying(self.cuts)
        graphs._CAPTURING.append(rep)
        try:
            self.body(self.cap.bufs, self.cap.state)
        finally:
            graphs._CAPTURING.pop()
        assert rep.at == len(self.cuts), "a replay met fewer collectives"


def _fake_capture(self, name):
    """``Captured._capture`` without a card: the same warm-up, then a
    capture that records the body without running it (the body's launches
    go to its segments' tallies, its collectives are cut and not issued,
    and the tensors, round counters among them, are put back: a capture
    advances nothing)."""
    body = self.bodies[name]
    rec = graphs._Recording(lambda: None, _FakeGraph, self.warm_up(body))
    saved = {k: v.clone() for k, v in self.bufs.items()}
    graphs._CAPTURING.append(rec)
    try:
        out = body(self.bufs, self.state)
        rec.finish()
    finally:
        graphs._CAPTURING.pop()
    for k, v in saved.items():
        self.bufs[k].copy_(v)
    self.graphs[name] = _FakeProgram(self, body, rec, out)
    graphs.STATS["graphs"] += len(rec.segments)


def _emulate_the_card(monkeypatch):
    """Every ``Captured`` that is not ``eager`` takes its card path on the
    CPU: warm-up, capture and replays, ``_FakeGraph``s in place of CUDA
    graphs."""
    monkeypatch.setattr(graphs.Captured, "device",
                        property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(graphs.Captured, "_capture", _fake_capture)
