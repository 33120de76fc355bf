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
- at most one **data axis** (any other name): the ranks of one data group
  run the same chains with the same random stream, each sums the
  likelihood terms of its slice of the sharded observed sites, and the
  samplers sum the parts over the group (``MeshComm.data_sum``).

Collectives run at the sampler boundary, on the outputs of
``torch.func.vmap``, never inside it.  Under gloo a CUDA tensor is staged
through the host; NCCL reduces on the device.  A mesh axis of size one
needs no collective, so a one-rank mesh gives the run without a mesh bit
for bit.

``pad_axes`` and ``pad_mask`` are numpy, with the JAX package's semantics:
a sharded dim that the mesh axis does not divide is edge-padded and its
tail masked out of the likelihood.
"""

from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

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


def rank_seed(seed: int, chain_rank: int) -> int:
    """The generator seed of a chain rank: ``seed`` itself on chain rank 0
    (so a one-rank mesh replays the run without a mesh), a seed derived
    from ``(seed, chain_rank)`` on the others."""
    if chain_rank == 0:
        return int(seed)
    words = np.random.SeedSequence([int(seed), int(chain_rank)]).generate_state(2)
    return int(words[0]) | (int(words[1]) << 32)


class MeshComm:
    """Collectives of one rank over a mesh's chain axis and its data axis.
    ``MeshComm()`` (no mesh) is one rank on both: every collective is the
    identity, and so is every collective over an axis of size one.

    - ``chain_sum``/``chain_mean``: over every chain of every chain rank;
    - ``gather_chains``: chain-stacked rows of every chain rank, in global
      chain order;
    - ``chain_broadcast``: chain rank 0's value on every chain rank;
    - ``data_sum``: the parts of a split density, summed over the data
      group.

    The chain axis's ranks hold the same number of chains."""

    def __init__(self, mesh: DeviceMesh | None = None,
                 chain_axis: str = CHAIN_AXIS):
        self.mesh = mesh
        self.chain_axis = chain_axis
        self.data_axis = None
        self.chain_rank, self.chain_size, self._chain_group = 0, 1, None
        self.data_rank, self.data_size, self._data_group = 0, 1, None
        if mesh is None:
            return
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh (make_mesh), "
                            f"got {type(mesh).__name__}")
        names = tuple(mesh.mesh_dim_names or ())
        if chain_axis not in names:
            raise ValueError(f"mesh axes {names} have no chain axis "
                             f"{chain_axis!r}")
        others = [n for n in names if n != chain_axis]
        if len(others) > 1:
            raise ValueError(f"mesh axes {names}: the chain axis and at most "
                             f"one data axis")
        self.chain_rank = mesh.get_local_rank(chain_axis)
        self.chain_size = mesh.size(names.index(chain_axis))
        self._chain_group = mesh.get_group(chain_axis)
        if others:
            self.data_axis = others[0]
            self.data_rank = mesh.get_local_rank(self.data_axis)
            self.data_size = mesh.size(names.index(self.data_axis))
            self._data_group = mesh.get_group(self.data_axis)

    @property
    def sharded(self) -> bool:
        """Whether this rank holds a part of the chains or of the data."""
        return self.chain_size > 1 or self.data_size > 1

    def local_chains(self, nchains: int) -> int:
        if nchains % self.chain_size:
            raise ValueError(f"{nchains} chains do not divide over the "
                             f"{self.chain_size} ranks of the chain axis")
        return nchains // self.chain_size

    # ---- collectives ---------------------------------------------------
    @staticmethod
    def _staged(group) -> bool:
        """gloo reduces host tensors: CUDA tensors go through the host."""
        return dist.get_backend(group) != "nccl"

    def _all_sum(self, group, tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        buf = flat.cpu() if self._staged(group) else flat
        dist.all_reduce(buf, group=group)
        buf = buf.to(flat.device)
        out, at = [], 0
        for t in tensors:
            out.append(buf[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out

    def data_sum(self, *tensors):
        """Each tensor summed over the data group (one all-reduce for all;
        one dtype).  Returns a tuple."""
        if self.data_size == 1:
            return tensors
        return tuple(self._all_sum(self._data_group, tensors))

    def chain_sum(self, *tensors):
        """Each tensor summed over the chain ranks.  Returns a tuple."""
        if self.chain_size == 1:
            return tensors
        return tuple(self._all_sum(self._chain_group, tensors))

    def chain_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over dim 0 of the chain-stacked ``x`` across every chain of
        every chain rank (``torch.mean`` itself on one rank)."""
        if self.chain_size == 1:
            return torch.mean(x, dim=0)
        (s,) = self.chain_sum(torch.sum(x, dim=0))
        return s / (x.shape[0] * self.chain_size)

    def gather_chains(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every chain rank's ``x`` concatenated along its chain dim ``dim``
        in chain-rank order: the global chain order."""
        if self.chain_size == 1:
            return x
        g = self._chain_group
        buf = x.movedim(dim, 0).contiguous()
        if self._staged(g):
            buf = buf.cpu()
        parts = [torch.empty_like(buf) for _ in range(self.chain_size)]
        dist.all_gather(parts, buf, group=g)
        return torch.cat(parts).to(x.device).movedim(0, dim)

    def chain_broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Chain rank 0's ``x`` on every chain rank."""
        if self.chain_size == 1:
            return x
        g = self._chain_group
        buf = x.cpu().clone() if self._staged(g) else x.clone()
        dist.broadcast(buf, src=dist.get_global_rank(g, 0), group=g)
        return buf.to(x.device)

    def shard_state(self) -> dict:
        """This rank's coordinates, as chain files record them."""
        return {"chain_rank": self.chain_rank, "chain_size": self.chain_size,
                "data_rank": self.data_rank, "data_size": self.data_size}
