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
tensors back, and captures the body in one graph (one per segment where
it reaches a collective, below), which ``run(n)`` replays ``n`` times.
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

A body may reach a collective over a mesh's data group (a split density's
all-reduce, the all-gather of a whole value: ``parallel/mesh.py``), as the
JAX package's compiled program holds the all-reduces and all-gathers that
GSPMD inserts.  A CUDA graph cannot hold a collective that goes through
the host, so the capture cuts the body there: the collective hands itself
to the capture (``cut``), which ends the graph being captured, records the
collective as a host step (``Cut``: its input, which the graph before it
writes, and an output buffer allocated once, which the graph after it
reads) without issuing it, and captures the rest of the body in a new
graph that shares the first one's memory pool.  A captured body is thus a
``Program``: segments (CUDA graphs) and the cuts between them, which
``run(n)`` replays in capture order, segment 0, cut 0, segment 1 and so
on, ``n`` times.  The warm-ups issue their collectives for real, and the
capture checks that it meets the same collectives, over the same group
of mesh axes, of the same shapes and dtypes, in the same order; a capture
that differs raises.  Every rank
of a data group runs the same bodies the same number of times, so all cut
at the same places.

A kernel wrapper counts its launches with ``count_launch``: a launch made
while a graph is being captured goes to the tally of the segment being
captured, and every replay adds the tallies to the counts, so a count read
after a run holds every launch the device made, replays included.
``disabled()`` makes the engine build its samplers without captured steps
(their plain loops), for a density that cannot be captured and for the
graph-against-plain checks: it is the one way to the plain loops.
"""

from __future__ import annotations

import contextlib
import gc
import time
import warnings

import torch

__all__ = ["Captured", "Cut", "Program", "count_launch", "capturing", "cut",
           "disabled", "enabled", "idle", "issued", "until_done", "STATS",
           "GROUP_COLLECTIVES"]

#: graphs captured (a body cut at its collectives counts one per segment),
#: seconds spent capturing them (warm-ups included), graph replays (one per
#: segment), host tests of a device flag (``until_done``), collectives run
#: between replays and the host seconds they took, since the process
#: started; ``model/mcmc.py`` reports what each run added
STATS = {"graphs": 0, "capture_s": 0.0, "replays": 0, "host_tests": 0,
         "collectives": 0, "collective_s": 0.0}
#: the collectives run between replays, per group of mesh axes they ran
#: over (``("data", "week")``)
GROUP_COLLECTIVES: dict[tuple, int] = {}

#: launch tallies of the captures in progress (one per nesting level; a
#: ``_Recording`` is the tally of the segment it captures)
_CAPTURING: list[dict] = []
#: the collectives each warm-up in progress issued, as signatures
_WARMING: list[list] = []
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


class Cut:
    """A collective between two segments of a captured body: ``issue()``
    reads ``inp``, which the segment before it writes, and writes ``out``,
    which the segment after it reads (the same tensor for a collective in
    place).  ``kind`` names it (``"all_reduce"``, ``"all_gather"``) and
    ``group`` the mesh axes it runs over."""

    __slots__ = ("kind", "inp", "out", "issue", "group")

    def __init__(self, kind: str, inp: torch.Tensor, out: torch.Tensor, issue,
                 group: tuple = ()):
        self.kind, self.inp, self.out, self.issue = kind, inp, out, issue
        self.group = tuple(group)

    def run(self) -> None:
        t0 = time.perf_counter()
        self.issue()
        STATS["collectives"] += 1
        STATS["collective_s"] += time.perf_counter() - t0
        GROUP_COLLECTIVES[self.group] = GROUP_COLLECTIVES.get(self.group, 0) + 1


def _signature(kind: str, inp: torch.Tensor, group: tuple = ()) -> tuple:
    return kind, tuple(group), tuple(inp.shape), inp.dtype


def issued(kind: str, inp: torch.Tensor, group: tuple = ()) -> None:
    """A collective ``kind`` of ``inp`` over the mesh axes ``group``
    issued eagerly (``parallel/mesh.py``): noted while a body warms up, so
    that its capture can check that it meets the same collectives."""
    if _WARMING:
        _WARMING[-1].append(_signature(kind, inp, group))


def cut(kind: str, inp: torch.Tensor, make, group: tuple = ()):
    """Hand the collective ``kind`` of ``inp`` over the mesh axes
    ``group`` to the capture in progress: ``make()`` allocates its buffers
    once and returns ``(out, issue)`` (``Cut``); the capture ends its
    segment there, records the cut without issuing it, goes on in a new
    segment and returns ``out``, which the rest of the body reads."""
    rec = _CAPTURING[-1]
    if not isinstance(rec, _Recording):
        raise RuntimeError(f"a {kind} inside a capture that cannot cut")
    return rec.cut(kind, inp, make, group)


class _Recording(dict):
    """A body's capture in progress, itself the launch tally of the
    segment being captured (``count_launch``).  ``begin()`` starts a
    segment's capture and ``end()`` ends it, returning its graph;
    ``expected`` holds the signatures of the collectives the warm-up
    issued."""

    def __init__(self, begin, end, expected=None):
        super().__init__()
        self._begin, self._end, self.expected = begin, end, expected
        self.segments: list = []       # (graph, launch tally)
        self.cuts: list[Cut] = []

    def _close(self) -> None:
        self.segments.append((self._end(), dict(self)))
        self.clear()

    def cut(self, kind: str, inp: torch.Tensor, make, group: tuple = ()):
        k = len(self.cuts)
        sig = _signature(kind, inp, group)
        if self.expected is not None and (k >= len(self.expected)
                                          or self.expected[k] != sig):
            want = self.expected[k] if k < len(self.expected) else "none"
            raise RuntimeError(
                f"capture cut {k} is a collective {sig}, where the warm-up "
                f"issued {want}: the body must meet the same collectives at "
                f"every run")
        self._close()
        out, issue = make()
        self.cuts.append(Cut(kind, inp, out, issue, group))
        self._begin()
        return out

    def finish(self) -> None:
        self._close()
        if self.expected is not None and len(self.cuts) != len(self.expected):
            raise RuntimeError(
                f"the capture met {len(self.cuts)} collectives, where the "
                f"warm-up issued {len(self.expected)}")


class Program:
    """A captured body: its segments' graphs, with each one's launch tally,
    the cuts between them, and ``out``, what the body returned.
    ``replay()`` runs segment 0, cut 0, segment 1 and so on."""

    def __init__(self, segments, cuts, out):
        self.segments, self.cuts, self.out = segments, cuts, out

    def replay(self) -> None:
        for (graph, _), c in zip(self.segments, self.cuts):
            graph.replay()
            c.run()
        self.segments[-1][0].replay()


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
        self.graphs: dict[str, Program] = {}
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
        prog = self.graphs[name]
        for _ in range(n):
            prog.replay()
        self.replays += n
        STATS["replays"] += n * len(prog.segments)
        for _, tally in prog.segments:
            for fn, launches in tally.items():
                fn.launches += launches * n
        return prog.out

    def warm_up(self, body) -> list:
        """Run ``body`` twice, each time from the tensors as they stand (as
        its replay will: a body that advances an index or a round counter
        on the device must not run past its range), then put the tensors
        back.  Its collectives are issued; returns the signatures of the
        second run's, which the capture must meet."""
        saved = {k: v.clone() for k, v in self.bufs.items()}
        for _ in range(2):
            for k, v in saved.items():
                self.bufs[k].copy_(v)
            _WARMING.append([])
            try:
                body(self.bufs, self.state)
            finally:
                met = _WARMING.pop()
        for k, v in saved.items():
            self.bufs[k].copy_(v)
        return met

    def _capture(self, name: str) -> None:
        t0 = time.perf_counter()
        body = self.bodies[name]
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):       # warm up before the capture
            expected = self.warm_up(body)
        main.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        graph = [None]

        def begin():
            graph[0] = torch.cuda.CUDAGraph()
            graph[0].capture_begin(pool=pool, capture_error_mode="thread_local")

        def end():
            with warnings.catch_warnings():
                # a segment between two collectives may launch nothing
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                graph[0].capture_end()
            return graph[0]

        rec = _Recording(begin, end, expected)
        torch.cuda.synchronize(dev)
        with _collector_paused(), torch.cuda.stream(side):
            _CAPTURING.append(rec)
            begin()
            try:
                out = body(self.bufs, self.state)
                rec.finish()
            except Exception as e:
                if len(rec.segments) == len(rec.cuts):   # a capture is open
                    try:
                        graph[0].capture_end()
                    except RuntimeError:     # invalidated by the failure
                        pass
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
        self.graphs[name] = Program(rec.segments, rec.cuts, out)
        STATS["graphs"] += len(rec.segments)
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
