"""Captured steps: a sampler's inner loop body recorded once as a CUDA graph
and replayed.

Counterpart of the JAX engine's compiled programs: there the warm-up and
kept-draw scans are jitted, and NUTS's subtree and ChEES's trajectory are
``lax.while_loop``s inside them (``mamba_tpu/model/mcmc.py``,
``samplers/nuts.py``, ``samplers/chees.py``).  Here the host keeps the
loops, and the body a loop repeats (a NUTS leaf, a ChEES leapfrog, a DGS
sweep) is captured with ``torch.cuda.CUDAGraph``: one replay issues the
tens of kernels of the body without going through Python.

A ``Captured`` owns the body's tensors, ``bufs`` (its inputs and the state
it carries) and ``state`` (the chain-stacked state of the model that the
block's density closes over).  ``load`` and ``load_state`` copy values in;
``run(n)`` runs the body ``n`` times.  The body reads its tensors and
writes the new values of the carried ones back into them in place, so that
chained replays advance the same tensors with no copy between them: the
port updates in place where the JAX package is pure.  A graph records
addresses, so the tensors are allocated once and a change of shape, dtype
or device drops the graph, which is captured again at the next ``run``.

The capture runs the body twice on a side stream, each time from the
tensors as they stand (first-use work, such as building a kernel's library
or functorch's caches, happens there, never inside the capture), puts the
tensors back, and captures the body in one graph, which ``run(n)`` replays
``n`` times.
A failed capture raises; there is no eager fallback on a CUDA device.  On
the CPU nothing is captured: ``run`` calls the body eagerly on the same
tensors.

A loop that repeats a body until no chain is left (a slice sampler's
shrink trips, BHMC's wall hits) runs it in batches of trips: ``until_done``
runs one body, then another while a flag the bodies write on the device
says a chain is still at work, reading the flag once per batch (a host
test, counted in ``STATS["host_tests"]``).  The trips of a batch after
every chain has stopped are masked no-ops, so a body run eagerly ends its
batch at the first trip that finds no chain at work (``idle``), with the
same result and no device time spent on the rest.  A ``Captured`` built
with ``eager=True`` runs its bodies eagerly on every device: the samplers'
plain loops run the same bodies that way, so the two give the same
numbers.

A body may draw inside it (MISS's imputations, ABC's simulations: a
distribution's ``sample`` draws there): from per-chain keys held in its
buffers (``ops/random.py``; each draw is a launch of the threefry kernel,
which the graph captures), folded with a round counter that the body
advances in place, so that a replay draws the next numbers, as the body
run eagerly would.  The warm-ups put the counter back with the other
tensors.  The other samplers make every draw before their replay.

A kernel wrapper counts its launches with ``count_launch``: a launch made
while a graph is being captured goes to that graph's tally, and every
replay adds its tally to the counts, so a count read after a run holds
every launch the device made, replays included.  ``disabled()`` makes the
engine build its samplers without captured steps (their plain loops), for
a density that cannot be captured and for the graph-against-plain checks.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

__all__ = ["Captured", "count_launch", "capturing", "disabled", "enabled",
           "idle", "until_done", "STATS"]

#: graphs captured, seconds spent capturing them (warm-ups included), graph
#: replays and host tests of a device flag (``until_done``), since the
#: process started; ``model/mcmc.py`` reports what each run added
STATS = {"graphs": 0, "capture_s": 0.0, "replays": 0, "host_tests": 0}

#: launch tallies of the captures in progress (one per nesting level)
_CAPTURING: list[dict] = []
_DISABLED = [False]
#: bodies being run eagerly by ``Captured.run`` (nesting depth)
_EAGER = [0]


def count_launch(fn) -> None:
    """One launch of ``fn``'s kernel: ``fn.launches += 1``, or, inside a
    capture, one more launch of every replay of the graph."""
    if _CAPTURING:
        tally = _CAPTURING[-1]
        tally[fn] = tally.get(fn, 0) + 1
    else:
        fn.launches += 1


def capturing() -> bool:
    """Whether a graph is being captured in this process."""
    return bool(_CAPTURING)


def idle(flags: torch.Tensor) -> bool:
    """Whether a body that ``Captured.run`` runs eagerly may end its batch
    of trips here: no element of ``flags`` (the chains still at work) is
    set, so the trips left would be masked no-ops.  Reads ``flags`` on the
    host; False, with no read, in a warm-up or a capture, which record the
    whole batch."""
    return _EAGER[0] > 0 and not bool(flags.any())


def enabled() -> bool:
    """Whether the engine builds captured steps (``disabled`` not active)."""
    return not _DISABLED[0]


@contextlib.contextmanager
def disabled():
    """Within the block, block kernels are built with the samplers' plain
    loops and capture nothing (kernels built before keep what they have)."""
    before = _DISABLED[0]
    _DISABLED[0] = True
    try:
        yield
    finally:
        _DISABLED[0] = before


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector off for the block (after one
    collection): an object it frees inside a capture may destroy a CUDA
    graph or event, which a capturing stream does not permit, and the
    capture fails."""
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.device == b.device


class Captured:
    """Bodies ``body(bufs, state)`` run on tensors of their own, each from a
    CUDA graph of its own on a CUDA device.  ``bodies`` is one body or a
    dict of named bodies that share the tensors (a first trip batch and the
    batches after it); ``run(n, name)`` runs the body of that name (the one
    body: ``"body"``).  A body updates ``bufs`` in place and may return
    tensors: ``run`` returns what the last body of the run returned, on a
    CUDA device the graph's own tensors, which the next replay overwrites.
    With ``eager=True`` nothing is captured on any device."""

    def __init__(self, bodies, eager: bool = False):
        self.bodies = bodies if isinstance(bodies, dict) else {"body": bodies}
        self.eager = eager
        self.bufs: dict[str, torch.Tensor] = {}
        self.state: dict[str, torch.Tensor] = {}
        self._loaded: dict[str, torch.Tensor] = {}
        self.graphs: dict = {}              # name -> (graph, out, tally)
        self.replays = 0

    def _put(self, store: dict, name: str, value: torch.Tensor) -> None:
        held = store.get(name)
        if held is None or not _same_layout(held, value):
            store[name] = value.detach().clone(memory_format=torch.contiguous_format)
            self.graphs.clear()
        else:
            held.copy_(value)

    def load(self, **values) -> None:
        """Copy each value into the buffer of its name (allocated at first
        use or when the layout changes)."""
        for name, value in values.items():
            self._put(self.bufs, name, value)

    def holds(self, name: str, like: torch.Tensor) -> bool:
        """Whether the buffer ``name`` exists with ``like``'s shape, dtype
        and device (else a step allocates its buffers anew)."""
        held = self.bufs.get(name)
        return held is not None and _same_layout(held, like)

    def load_state(self, state: dict) -> None:
        """Copy the model state into ``state``, skipping a tensor that is
        the very one loaded last under its name: the engine never writes a
        state tensor in place, so only the blocks that moved are copied."""
        for name, value in state.items():
            if self._loaded.get(name) is value and name in self.state:
                continue
            self._put(self.state, name, value)
            self._loaded[name] = value

    @property
    def device(self) -> torch.device:
        return next(iter(self.bufs.values())).device

    def run(self, n: int = 1, name: str = "body"):
        out = None
        if self.eager or self.device.type != "cuda":
            body = self.bodies[name]
            _EAGER[0] += 1
            try:
                for _ in range(n):
                    out = body(self.bufs, self.state)
            finally:
                _EAGER[0] -= 1
            return out
        if name not in self.graphs:
            self._capture(name)
        graph, out, tally = self.graphs[name]
        for _ in range(n):
            graph.replay()
        self.replays += n
        STATS["replays"] += n
        for fn, launches in tally.items():
            fn.launches += launches * n
        return out

    def warm_up(self, body) -> None:
        """Run ``body`` twice, each time from the tensors as they stand (as
        its replay will: a body that advances an index or a round counter
        on the device must not run past its range), then put the tensors
        back."""
        saved = {k: v.clone() for k, v in self.bufs.items()}
        for _ in range(2):
            for k, v in saved.items():
                self.bufs[k].copy_(v)
            body(self.bufs, self.state)
        for k, v in saved.items():
            self.bufs[k].copy_(v)

    def _capture(self, name: str) -> None:
        t0 = time.perf_counter()
        body = self.bodies[name]
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):       # warm up before the capture
            self.warm_up(body)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        tally: dict = {}
        with _collector_paused():
            _CAPTURING.append(tally)
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    out = body(self.bufs, self.state)
            except Exception as e:
                fn = getattr(body, "func", body)
                raise RuntimeError(
                    f"capturing {getattr(fn, '__qualname__', fn)} "
                    f"as a CUDA graph failed: a body must not wait for the "
                    f"device or copy from the host (run the sampler under "
                    f"mamba_tpu_torch.utils.graphs.disabled() to take its "
                    f"plain loop): {e}") from e
            finally:
                _CAPTURING.pop()
        torch.cuda.synchronize(dev)
        self.graphs[name] = (graph, out, tally)
        STATS["graphs"] += 1
        STATS["capture_s"] += time.perf_counter() - t0


def until_done(cap: Captured, first: str, more: str, limit: int,
               draw=None) -> int:
    """Run ``cap``'s body ``first`` once, then, while the device flag
    ``cap.bufs["more"]`` is set, ``draw(j)`` (which loads the random
    numbers of batch ``j``, 1 for the first ``more``) and the body ``more``,
    at most ``limit`` bodies in all.
    Each read of the flag is one host test.  Returns the bodies run."""
    cap.run(1, first)
    runs = 1
    while runs < limit:
        STATS["host_tests"] += 1
        if not bool(cap.bufs["more"]):
            break
        if draw is not None:
            draw(runs)
        cap.run(1, more)
        runs += 1
    return runs
