"""Device meshes for chain-parallel (and data-parallel) MCMC on
``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``.  There, one
controller shards chain-stacked arrays over a ``jax.sharding.Mesh`` and
GSPMD inserts the collectives into one compiled scan.  Here, as PyTorch
runs, there is one process per device (``torchrun``, or processes spawned
with a rendezvous), and a ``torch.distributed.device_mesh.DeviceMesh``
names the axes:

- the **chain axis** (``"chains"``): each rank holds ``chains / size`` of
  the chains and runs the engine's host loop on them; cross-chain
  statistics (ChEES, SMC) and the kept draws are collectives over the
  ranks of that axis;
- any number of **data axes** (every other name): the ranks that share a
  chain rank are a **data group**, the product of the data axes flattened
  in mesh order, and run the same chains with the same random stream.
  ``site_specs`` takes what a ``PartitionSpec`` takes: an entry per dim of
  an array, ``None``, one axis or a tuple of axes, whose sizes multiply
  and whose first axis is major (``data_dim``: a map of dims to axes; an
  axis names one dim at most).  Each rank holds only its block
  (``DataGroup.block``) of every input and site so named (a sampled site
  where its sampler can hold a slice: ``BlockCoords``), and evaluates its
  density's terms on that block.  A value cut over a set S of the data
  axes is replicated over the others, and counts once: on the ranks at
  index 0 of every data axis outside S (``DataGroup.leads``).  The
  samplers sum the parts over the group (``MeshComm.data_sum``), and a
  reader of a whole value gathers it (``MeshComm.gather_data``).

Collectives run at the sampler boundary, on the outputs of
``torch.func.vmap``, never inside it.  Under gloo a CUDA tensor is staged
through the host; NCCL reduces on the device.  Inside a captured body
(``utils/graphs.py``) a collective is not issued: it hands itself to the
capture as a cut between two CUDA graphs, with buffers of its own (pinned
host ones under gloo), and runs between their replays.  A mesh axis of size one
needs no collective, so a one-rank mesh gives the run without a mesh bit
for bit.

``pad_axes`` and ``pad_mask`` are numpy, with the JAX package's semantics:
each sharded dim that its mesh axes do not divide is edge-padded and its
tail masked out of the likelihood; the padded length then divides, and
``data_block`` cuts it into equal slices.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils import graphs

#: the chain axis's default name, as in the JAX package
CHAIN_AXIS = "chains"


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def distributed_init(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     *, device_type: str = "cuda",
                     timeout: float | None = None) -> None:
    """Join the process group: NCCL for ``device_type="cuda"``, gloo for
    ``"cpu"``.  The arguments default to
    ``torchrun``'s environment (``env://``); a multi-process test passes a
    ``file://`` rendezvous, its world size and its rank.  ``timeout`` (s)
    bounds every collective, so a rank whose peer died fails instead of
    waiting forever.  A no-op if the group is up already."""
    if dist.is_initialized():
        return
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(_backend(device_type),
                            init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)


def _init_world(device_type: str) -> None:
    """The process group a mesh needs: ``torchrun``'s if its environment is
    set, else a group of this process alone (an in-memory store), so that a
    one-rank mesh works in a plain process."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        distributed_init(device_type=device_type)
        return
    dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(axes: dict[str, int] | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """``make_mesh({"chains": 2, "data": 2})``: a ``DeviceMesh`` over the
    world group, ranks laid out row-major.  With no spec, a 1-D ``chains``
    mesh over every rank.  ``device_type`` defaults to the running group's
    (``"cuda"`` under NCCL, ``"cpu"`` under gloo), else ``"cuda"``; with no
    group running, the world is this process alone."""
    if device_type is None:
        device_type = ("cuda" if not dist.is_initialized()
                       or dist.get_backend() == "nccl" else "cpu")
    _init_world(device_type)
    world = dist.get_world_size()
    if axes is None:
        axes = {CHAIN_AXIS: world}
    shape = tuple(int(v) for v in axes.values())
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {axes} needs {math.prod(shape)} ranks, "
                         f"have {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(axes))


def global_mesh(axes: dict[str, int] | None = None) -> DeviceMesh:
    """Mesh over every rank of the running process group (join it first
    with ``distributed_init`` on every rank)."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh: no process group; call "
                           "distributed_init on every rank first")
    return make_mesh(axes)


def _axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a plain mapping."""
    if isinstance(mesh, DeviceMesh):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return {str(k): int(v) for k, v in dict(mesh).items()}


def _spec_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_divisor(sizes: dict[str, int], entry) -> int:
    """Number of shards a spec entry (None, an axis name or a tuple of
    names) implies."""
    return math.prod(sizes[n] for n in _spec_names(entry))


def chain_sharding(mesh: DeviceMesh, nchains: int,
                   chain_axis: str = CHAIN_AXIS) -> slice:
    """This rank's slice of a chain axis of ``nchains``: the chain axis's
    ranks hold equal, consecutive blocks in rank order."""
    comm = MeshComm(mesh, chain_axis)
    per = comm.local_chains(nchains)
    return slice(comm.chain_rank * per, (comm.chain_rank + 1) * per)


def shard_chain_tree(tree, mesh: DeviceMesh, nchains: int,
                     chain_axis: str = CHAIN_AXIS):
    """This rank's part of a chain-stacked tree (dicts, tuples, lists of
    tensors or arrays): leaves whose leading dim is ``nchains`` are sliced
    to ``chain_sharding``; everything else is replicated as it is."""
    sl = chain_sharding(mesh, nchains, chain_axis)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(put(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        shape = np.shape(x)
        return x[sl] if shape and shape[0] == nchains else x
    return put(tree)


def pad_axes(mesh, site_specs: dict, arrays: dict, mode: str = "edge"):
    """Pad the arrays named in ``site_specs`` so every sharded dim divides by
    its mesh axes' size.  ``mesh`` is a ``DeviceMesh`` or a mapping of axis
    sizes.  Specs index the array's own dims: ``{"y": ("data",)}`` shards
    y's dim 0, ``{"xmat": ("data", None)}`` xmat's dim 0.  Padding repeats
    edge values (inside the distribution's support); the engine masks their
    likelihood terms to exactly zero.

    Returns ``(padded_arrays, pads)`` with ``pads[name][dim] = (orig, new)``
    for every dim padded."""
    sizes = _axis_sizes(mesh)
    out = dict(arrays)
    pads: dict[str, dict[int, tuple[int, int]]] = {}
    for name, spec in site_specs.items():
        if name not in arrays:
            continue
        a = np.asarray(arrays[name])
        widths = [(0, 0)] * a.ndim
        info = {}
        for dim, entry in enumerate(tuple(spec)):
            div = _spec_divisor(sizes, entry)
            if div <= 1:
                continue
            if dim >= a.ndim:
                raise ValueError(
                    f"site spec {spec} for {name!r} names dim {dim} but the "
                    f"array has shape {a.shape}")
            new = -(-a.shape[dim] // div) * div
            if new != a.shape[dim]:
                widths[dim] = (0, new - a.shape[dim])
                info[dim] = (a.shape[dim], new)
        if info:
            out[name] = np.pad(a, widths, mode=mode)
            pads[name] = info
    return out, pads


def pad_mask(shape: tuple, pads: dict[int, tuple[int, int]]) -> np.ndarray:
    """Boolean mask over ``shape``: True for real entries, False for the
    padded tail of each padded dim."""
    mask = np.ones(shape, dtype=bool)
    for dim, (orig, _new) in pads.items():
        idx = [slice(None)] * len(shape)
        idx[dim] = slice(orig, None)
        mask[tuple(idx)] = False
    return mask


def data_dim(spec, data_axes, chain_axis: str = CHAIN_AXIS) -> dict:
    """The dims of an array that its site spec cuts over the data axes
    ``data_axes`` (a name or a tuple of names), each with the axes that
    cut it in the spec's order (its first axis major): ``{dim: axes}``,
    empty if no dim is cut.  Names of other axes are left out.  An axis
    names one dim at most, and a spec never names the chain axis: the
    chain axis is the engine's leading dim, not one of a site's own."""
    data_axes = (data_axes,) if isinstance(data_axes, str) else tuple(data_axes)
    out, seen = {}, {}
    for dim, entry in enumerate(tuple(spec)):
        names = _spec_names(entry)
        if chain_axis in names:
            raise ValueError(f"site spec {spec} names the chain axis "
                             f"{chain_axis!r}")
        for n in names:
            if n in seen and n in data_axes:
                raise ValueError(f"site spec {spec} names the data axis "
                                 f"{n!r} on more than one dim")
            seen[n] = dim
        axes = tuple(n for n in names if n in data_axes)
        if axes:
            out[dim] = axes
    return out


def data_block(x, dim: int, rank: int, size: int):
    """The ``rank``-th of ``size`` equal, consecutive blocks of ``x`` along
    ``dim`` (a view of a tensor).  The dim's length is the padded one
    ``pad_axes`` leaves, so it divides; any other length raises.  A rank's
    block over several dims is this along each (``DataGroup.block``)."""
    n = x.shape[dim]
    per, rem = divmod(n, size)
    if rem:
        raise ValueError(f"dim {dim} of length {n} does not divide over the "
                         f"{size} ranks of the data axis; pad it (pad_axes)")
    return x[(slice(None),) * dim + (slice(rank * per, (rank + 1) * per),)]


class DataGroup:
    """The data axes of a mesh (``axes``, their sizes ``shape``, in mesh
    order) as one rank of a data group sees them: ``rank``, its place in
    the group flattened row-major.  A **layout** is ``{dim: axes}``
    (``data_dim``): the dims of an array cut over the data axes, each by
    the product of its axes' sizes, its first axis major, as
    ``NamedSharding`` orders the blocks.  Group ranks ``k`` other than the
    rank's own serve the compiler's probe, which evaluates every block."""

    def __init__(self, axes=(), shape=(), rank: int = 0):
        self.axes = tuple(axes)
        self.shape = tuple(int(n) for n in shape)
        self.sizes = dict(zip(self.axes, self.shape))
        self.size = math.prod(self.shape)
        self.rank = rank

    def coords(self, k: int | None = None) -> dict:
        """Group rank ``k``'s (default: this rank's) index on each axis."""
        k = self.rank if k is None else k
        if not self.axes:
            return {}
        return dict(zip(self.axes, (int(i) for i in
                                    np.unravel_index(k, self.shape))))

    def layout(self, layout) -> dict:
        """``layout`` without its axes of size one (a cut into one block)
        and the dims left with none."""
        out = {}
        for dim, axes in dict(layout).items():
            axes = tuple(a for a in axes if self.sizes.get(a, 1) > 1)
            if axes:
                out[int(dim)] = axes
        return out

    def count(self, axes) -> int:
        """The blocks that ``axes`` cut a dim into."""
        return math.prod(self.sizes[a] for a in axes)

    def blocks(self, layout, k: int | None = None) -> dict:
        """Per dim of ``layout``, rank ``k``'s block there: ``(index,
        count)``."""
        c = self.coords(k)
        out = {}
        for dim, axes in layout.items():
            index = 0
            for a in axes:
                index = index * self.sizes[a] + c[a]
            out[dim] = (index, self.count(axes))
        return out

    def block(self, x, layout, k: int | None = None, lead: int = 0):
        """Rank ``k``'s block of ``x`` (``lead`` dims before the array's
        own) under ``layout``."""
        for dim, (index, count) in self.blocks(layout, k).items():
            x = data_block(x, lead + dim, index, count)
        return x

    def shape_of(self, shape, layout) -> tuple:
        """A block's shape of an array of ``shape`` under ``layout``."""
        return tuple(n // self.count(layout[d]) if d in layout else n
                     for d, n in enumerate(shape))

    def axes_of(self, layout) -> tuple:
        """The axes that ``layout`` cuts by, in mesh order."""
        used = {a for axes in layout.values() for a in axes}
        return tuple(a for a in self.axes if a in used)

    def leads(self, axes, k: int | None = None) -> bool:
        """Whether rank ``k`` counts a value cut over ``axes`` (or a
        layout's): it is at index 0 of every data axis outside them, so
        that each block counts once over the group."""
        if isinstance(axes, dict):
            axes = self.axes_of(axes)
        c = self.coords(k)
        return all(c[a] == 0 for a in self.axes if a not in axes)

    def layouts(self, whole, part) -> list:
        """The layouts under which a block of an array shaped ``whole`` is
        shaped ``part``, the axes of each dim in mesh order first."""
        whole, part = tuple(whole), tuple(part)
        if len(whole) != len(part):
            return []
        options = []
        for d, (w, p) in enumerate(zip(whole, part)):
            if w == p:
                continue
            if p <= 0 or w % p:
                return []
            axes = [a for a in self.axes if self.sizes[a] > 1]
            options.append([(d, t) for r in range(1, len(axes) + 1)
                            for t in itertools.permutations(axes, r)
                            if self.count(t) == w // p])
        out = []
        for choice in itertools.product(*options):
            used = [a for _, t in choice for a in t]
            if len(used) == len(set(used)):
                out.append(dict(choice))
        return out

    def assemble(self, parts, layout, lead: int = 0):
        """The whole array from its blocks ``parts (n, ...)``, one per rank
        of the axes ``axes_of(layout)`` in their row-major order (an
        all-gather over those axes; ``lead`` dims before the array's
        own)."""
        axes = self.axes_of(layout)
        sizes = [self.sizes[a] for a in axes]
        block = tuple(parts.shape[1:])
        x = parts.reshape(tuple(sizes) + block)
        order, shape = [], []
        for i, n in enumerate(block):
            cut = layout.get(i - lead, ()) if i >= lead else ()
            order += [axes.index(a) for a in cut] + [len(axes) + i]
            shape.append(n * self.count(cut))
        return x.permute(order).reshape(shape)


def _data_groups(mesh: DeviceMesh, names: tuple, data_axes: tuple) -> dict:
    """A process group per set of the mesh's data axes that cuts into more
    than one rank (``{axes: group}``, axes in mesh order): an axis's own
    is the mesh's; one over several axes is made here, every rank making
    every such group in the same order (``dist.new_subgroups_by_
    enumeration``: every rank of the world takes part), once per mesh."""
    made = getattr(mesh, "_mamba_data_groups", None)
    if made is not None:
        return made
    ranks = mesh.mesh
    made = {}
    for r in range(1, len(data_axes) + 1):
        for axes in itertools.combinations(data_axes, r):
            if math.prod(ranks.shape[names.index(a)] for a in axes) == 1:
                continue
            if len(axes) == 1:
                made[axes] = mesh.get_group(axes[0])
                continue
            at = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in at]
            every = ranks.permute(rest + at).reshape(
                -1, math.prod(ranks.shape[i] for i in at))
            made[axes], _ = dist.new_subgroups_by_enumeration(
                [row.tolist() for row in every])
    mesh._mamba_data_groups = made
    return made


class MeshComm:
    """Collectives of one rank over a mesh's chain axis and its data axes.
    ``MeshComm()`` (no mesh) is one rank on both: every collective is the
    identity, and so is every collective over axes of size one.

    ``data_axes``, ``data_shape``: the mesh's data axes (every axis but the
    chain axis) and their sizes, in mesh order; ``data_rank``,
    ``data_size``: this rank's place in its data group, flattened
    row-major, and the group's size; ``data``: the group's ``DataGroup``.

    - ``chain_sum``/``chain_mean``: over every chain of every chain rank;
    - ``gather_chains``: chain-stacked rows of every chain rank, in global
      chain order;
    - ``chain_broadcast``: chain rank 0's value on every chain rank;
    - ``data_sum``: the parts of a split density, summed over the data
      group, or over the ranks that differ on some of its axes only;
    - ``gather_data``: the blocks of the data group's ranks joined into
      the whole value; ``gather_data_many``: several tensors of every
      data rank in one all-gather;
    - ``gather_leaf``: a leaf of a resume state as one device would hold
      it (``output.fileio.write_chains``).

    A collective over several data axes runs on a process group of its
    own, which every rank makes at construction, in the same order.  The
    chain axis's ranks hold the same number of chains."""

    def __init__(self, mesh: DeviceMesh | None = None,
                 chain_axis: str = CHAIN_AXIS):
        self.mesh = mesh
        self.chain_axis = chain_axis
        self.data_axes, self.data_shape = (), ()
        self.chain_rank, self.chain_size, self._chain_group = 0, 1, None
        self.data_rank, self.data_size = 0, 1
        self._groups: dict = {}
        self.data = DataGroup()
        if mesh is None:
            return
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh (make_mesh), "
                            f"got {type(mesh).__name__}")
        names = tuple(mesh.mesh_dim_names or ())
        if chain_axis not in names:
            raise ValueError(f"mesh axes {names} have no chain axis "
                             f"{chain_axis!r}")
        self.chain_rank = mesh.get_local_rank(chain_axis)
        self.chain_size = mesh.size(names.index(chain_axis))
        self._chain_group = mesh.get_group(chain_axis)
        self.data_axes = tuple(n for n in names if n != chain_axis)
        self.data_shape = tuple(mesh.size(names.index(n))
                                for n in self.data_axes)
        coords = tuple(mesh.get_local_rank(n) for n in self.data_axes)
        self.data_size = math.prod(self.data_shape)
        self.data_rank = (int(np.ravel_multi_index(coords, self.data_shape))
                          if coords else 0)
        self.data = DataGroup(self.data_axes, self.data_shape, self.data_rank)
        self._groups = _data_groups(mesh, names, self.data_axes)

    @property
    def sharded(self) -> bool:
        """Whether this rank holds a part of the chains or of the data."""
        return self.chain_size > 1 or self.data_size > 1

    def local_chains(self, nchains: int) -> int:
        if nchains % self.chain_size:
            raise ValueError(f"{nchains} chains do not divide over the "
                             f"{self.chain_size} ranks of the chain axis")
        return nchains // self.chain_size

    def _data_group(self, axes=None):
        """``(axes, group, size)`` of the ranks that differ from this one
        on the data axes ``axes`` alone (default: all of them, the data
        group), axes of size one left out; ``group`` is None where that
        is this rank alone."""
        axes = self.data_axes if axes is None else tuple(axes)
        axes = tuple(a for a in self.data_axes
                     if a in axes and self.data.sizes[a] > 1)
        if not axes:
            return (), None, 1
        return axes, self._groups[axes], self.data.count(axes)

    # ---- collectives ---------------------------------------------------
    @staticmethod
    def _staged(group) -> bool:
        """gloo reduces host tensors: CUDA tensors go through the host."""
        return dist.get_backend(group) != "nccl"

    def _all_sum(self, group, tensors, over: tuple):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if graphs.capturing():
            buf = graphs.cut("all_reduce", flat,
                             lambda: self._reducer(group, flat), over)
        else:
            graphs.issued("all_reduce", flat, over)
            buf = flat.cpu() if self._staged(group) else flat
            dist.all_reduce(buf, group=group)
            buf = buf.to(flat.device)
        out, at = [], 0
        for t in tensors:
            out.append(buf[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out

    def _reducer(self, group, flat):
        """A captured body's all-reduce of ``flat`` as a cut between two of
        its graphs (``utils.graphs.cut``): ``(out, issue)``.  Under gloo
        through a pinned host buffer of its own into a device buffer; under
        NCCL in place, on the stream, with no host copy and no wait."""
        if not self._staged(group):
            return flat, lambda: dist.all_reduce(flat, group=group)
        host, out = _host_like(flat), torch.empty_like(flat)

        def issue():
            host.copy_(flat)
            dist.all_reduce(host, group=group)
            out.copy_(host, non_blocking=True)
        return out, issue

    def data_sum(self, *tensors, axes=None):
        """Each tensor summed over the data group, or over the ranks that
        differ from this one on the data axes ``axes`` alone (one
        all-reduce for all; one dtype).  Returns a tuple."""
        over, group, _ = self._data_group(axes)
        if group is None:
            return tensors
        return tuple(self._all_sum(group, tensors, over))

    def chain_sum(self, *tensors):
        """Each tensor summed over the chain ranks.  Returns a tuple."""
        if self.chain_size == 1:
            return tensors
        return tuple(self._all_sum(self._chain_group, tensors,
                                   (self.chain_axis,)))

    def chain_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over dim 0 of the chain-stacked ``x`` across every chain of
        every chain rank (``torch.mean`` itself on one rank)."""
        if self.chain_size == 1:
            return torch.mean(x, dim=0)
        (s,) = self.chain_sum(torch.sum(x, dim=0))
        return s / (x.shape[0] * self.chain_size)

    def _gather(self, group, size, x, dim, over: tuple):
        """Every rank's ``x`` of ``group`` joined along ``dim`` in rank
        order (staged through the host under gloo; a host tensor goes to
        the card under NCCL)."""
        buf = x.movedim(dim, 0).contiguous()
        if graphs.capturing():
            out = graphs.cut("all_gather", buf,
                             lambda: self._gatherer(group, size, buf), over)
            return out.movedim(0, dim)
        graphs.issued("all_gather", buf, over)
        if self._staged(group):
            buf = buf.cpu()
        elif buf.device.type == "cpu":
            buf = buf.cuda()
        parts = [torch.empty_like(buf) for _ in range(size)]
        dist.all_gather(parts, buf, group=group)
        return torch.cat(parts).to(x.device).movedim(0, dim)

    def _gatherer(self, group, size, buf):
        """A captured body's all-gather of ``buf`` along dim 0 as a cut
        (``_reducer``'s form): gloo through pinned host buffers of its own,
        NCCL into the device buffer on the stream."""
        out = buf.new_empty((size * buf.shape[0],) + tuple(buf.shape[1:]))
        if not self._staged(group):
            return out, lambda: dist.all_gather_into_tensor(out, buf,
                                                            group=group)
        host_in, host_out = _host_like(buf), _host_like(out)
        parts = list(host_out.view((size,) + tuple(buf.shape)).unbind(0))

        def issue():
            host_in.copy_(buf)
            dist.all_gather(parts, host_in, group=group)
            out.copy_(host_out, non_blocking=True)
        return out, issue

    def gather_chains(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every chain rank's ``x`` concatenated along its chain dim ``dim``
        in chain-rank order: the global chain order."""
        if self.chain_size == 1:
            return x
        return self._gather(self._chain_group, self.chain_size, x, dim,
                            (self.chain_axis,))

    def gather_data(self, x: torch.Tensor, layout, lead: int = 0) -> torch.Tensor:
        """The whole (padded) value that ``DataGroup.block`` cut, from this
        rank's block ``x`` (``lead`` dims before the array's own) and those
        of the ranks that differ from it on the layout's axes: one
        all-gather over those axes.  ``layout`` is ``{dim: axes}``, or a
        dim cut over every data axis in mesh order (the data group's
        blocks concatenated in data-rank order)."""
        if isinstance(layout, int):
            layout = {layout: self.data_axes}
        layout = self.data.layout(layout)
        over, group, size = self._data_group(self.data.axes_of(layout))
        if group is None:
            return x
        every = self._gather(group, size, x[None], 0, over)
        return self.data.assemble(every, layout, lead)

    def gather_data_many(self, tensors) -> list:
        """Every data rank's ``tensors`` (a list), in data-rank order: one
        all-gather for all those of one dtype (a gathered node's parents,
        ``CompiledModel.with_wholes``).  Returns a list per rank of lists
        shaped as ``tensors``."""
        tensors = list(tensors)
        over, group, size = self._data_group()
        if group is None:
            return [tensors]
        out = [[None] * len(tensors) for _ in range(size)]
        groups: dict = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.dtype, []).append(i)
        for ids in groups.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in ids])
            every = self._gather(group, size, flat[None], 0, over)
            for r in range(size):
                at = 0
                for i in ids:
                    n = tensors[i].numel()
                    out[r][i] = every[r, at:at + n].reshape(tensors[i].shape)
                    at += n
        return out

    def chain_broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Chain rank 0's ``x`` on every chain rank."""
        if self.chain_size == 1:
            return x
        g = self._chain_group
        buf = x.cpu().clone() if self._staged(g) else x.clone()
        dist.broadcast(buf, src=dist.get_global_rank(g, 0), group=g)
        return buf.to(x.device)

    # ---- a resume state, whole ----------------------------------------
    def _agree(self, group, size, x, label: str, over: tuple) -> None:
        """Raise, naming ``label``, unless every rank of ``group`` holds the
        same ``x`` (a tensor, NaN equal to NaN, or a Python value).  Every
        rank sees the same gathered values, so all raise together."""
        if size == 1:
            return
        if isinstance(x, torch.Tensor):
            every = self._gather(group, size, x[None], 0, over).to(x.device)
            same = all(_same(p, x) for p in every)
        else:
            every = [None] * size
            dist.all_gather_object(every, x, group=group)
            same = all(p == x for p in every)
        if not same:
            raise ValueError(f"the ranks of the mesh disagree on {label}, "
                             f"which every rank should hold equally")

    def gather_leaf(self, x, label: str, chains: int | None = None,
                    data_dim=None, coords: "BlockCoords | None" = None):
        """One leaf of a rank's resume state as one device would hold it:

        - ``data_dim`` given (a site this data rank holds in part: its
          layout, ``{dim: axes}`` with the chain dim counted): the blocks
          joined over the data group (``gather_data``);
        - ``coords`` holding a slice (a tune leaf per coordinate of a block
          that holds slices: NUTS's and ChEES's inverse mass): the ranks'
          coordinates joined into the unsharded flat order
          (``BlockCoords.join``);
        - ``chains`` given (a leaf held per chain: a site's value, a tune's
          ``CHAIN_LEAVES``): a tensor led by the rank's ``chains`` rows,
          joined over the chain group in chain-rank order; any other shape
          raises, naming ``label``;
        - neither (ChEES's agreed step size and mass matrix, a Slice
          width, a Python number): held equally by every rank, and kept
          once.

        Every leaf not cut by the data axis is checked to agree over the
        data group, and a leaf not held per chain over the chain group
        too; a disagreement raises, naming ``label``.  A collective: every
        rank calls it, leaf for leaf in the same order."""
        if data_dim is not None:
            x = self.gather_data(x, data_dim)
        elif coords is not None and coords.index is not None:
            x = coords.join(x)
        else:
            over, group, size = self._data_group()
            self._agree(group, size, x, label, over)
        if chains is None:
            self._agree(self._chain_group, self.chain_size, x, label,
                        (self.chain_axis,))
            return x
        if not (isinstance(x, torch.Tensor) and x.dim()
                and x.shape[0] == chains):
            raise ValueError(f"{label} is held per chain, but its shape "
                             f"{tuple(np.shape(x))} is not led by the "
                             f"rank's {chains} chains")
        return self.gather_chains(x, 0)


class BlockCoords:
    """A sampler block's flat coordinates as one data rank holds them.

    On a data axis a block of a sampler that can hold slices (NUTS,
    ChEES-HMC, unit-mass HMC and MALA) holds each named sampled site as
    this rank's block, as GSPMD shards it: the block's flat vector is the
    unsharded one's coordinates ``index`` (in its order), the whole sites'
    coordinates (``whole``, positions in the rank's vector), which every
    rank holds equally, and the rank's slice coordinates (``part``).  A
    slice coordinate whose site is cut over a set S of the data axes is
    held alike by the ranks that differ on the other data axes only;
    ``counted`` are the slice coordinates this rank counts (it is at index
    0 of every data axis outside its site's S), so that each counts once.
    ``WHOLE`` (``BlockCoords()``) is a block that holds no slice: its sums
    are ``torch.sum`` over the last dim and its draws the unsharded ones.

    - ``sums``: sums over the coordinates (a momentum's kinetic energy, a
      U-turn's dot products): the whole coordinates summed locally plus
      ``data_sum`` of the counted slice coordinates' local sums (one
      all-reduce for all over the data group), so every rank holds the
      same bits;
    - ``randn``: a standard normal per coordinate from the block's
      per-chain keys, drawn only at the rank's counters ``index`` of the
      unsharded flat vector (partitionable threefry, as GSPMD draws it), so
      every rank draws the unsharded run's numbers, and the ranks that
      share a coordinate the same ones;
    - ``cut``: a per-coordinate value of the unsharded flat vector (a
      warm-start inverse mass) cut to the rank's coordinates;
    - ``join``: a per-coordinate leaf of every data rank put back into the
      unsharded flat order, each coordinate from any one of the ranks that
      hold it (a collective)."""

    def __init__(self, comm: MeshComm | None = None, indices=None,
                 whole=None, dim: int | None = None, counted=None):
        self.comm = comm or MeshComm()
        #: every data rank's ``index``, in data-rank order (None: no slice)
        self.indices = indices
        self.index = None if indices is None else indices[self.comm.data_rank]
        self.whole = whole
        self.part = self.counted = None
        if indices is not None:
            mask = torch.ones(len(self.index), dtype=torch.bool,
                              device=self.index.device)
            mask[whole] = False
            self.part = torch.nonzero(mask).reshape(-1)
            self.counted = self.part if counted is None else counted
        #: the unsharded flat vector's length
        self.dim = dim

    def sums(self, *xs):
        """Each ``x (..., rank dim)`` summed over its coordinates, completed
        over the data group (one all-reduce for all).  Returns a tuple."""
        if self.index is None:
            return tuple(torch.sum(x, dim=-1) for x in xs)
        parts = self.comm.data_sum(*(torch.sum(x.index_select(-1, self.counted),
                                               dim=-1) for x in xs))
        return tuple(torch.sum(x.index_select(-1, self.whole), dim=-1) + p
                     for x, p in zip(xs, parts))

    def sum(self, x):
        """``x (..., rank dim)`` summed over the block's coordinates."""
        return self.sums(x)[0]

    def randn(self, key, x, fold=None):
        """Standard normals shaped like ``x (C, ..., rank dim)`` from the
        per-chain keys ``key (C, 2)`` (folded with ``fold``): the unsharded
        run's draw at this rank's coordinates."""
        from ..ops import random as R
        per = tuple(x.shape[key.dim() - 1:])
        if self.index is None:
            return R.normal(key, per, x.dtype, fold=fold)
        return R.normal(key, per[:-1] + (self.dim,), x.dtype, fold=fold,
                        index=self.index)

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """``x (..., dim)``, per coordinate of the unsharded flat vector,
        cut to this rank's ``(..., rank dim)``; a value of any other shape
        (a scalar, a block with no slice) as it is."""
        if self.index is None or x.dim() == 0 or x.shape[-1] != self.dim:
            return x
        return x.index_select(-1, self.index.to(x.device))

    def join(self, x):
        """A leaf ``x (..., rank dim)`` of every data rank in the unsharded
        flat order ``(..., dim)``: each rank's coordinates where ``index``
        puts them (a collective; the identity for a block with no
        slice)."""
        if self.index is None:
            return x
        every = self.comm.gather_data(x[None], 0)
        out = x.new_empty(tuple(x.shape[:-1]) + (self.dim,))
        for part, index in zip(every, self.indices):
            out.index_copy_(-1, index.to(x.device), part)
        return out


#: the coordinates of a block that holds no slice
WHOLE = BlockCoords()


def _host_like(x: torch.Tensor) -> torch.Tensor:
    """A host buffer of ``x``'s shape and dtype, pinned for a CUDA ``x``."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same values (NaN equal to NaN)."""
    if a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
