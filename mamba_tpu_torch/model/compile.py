"""Graph compiler: Model -> log-density and pack/unpack functions on tensors.

Counterpart of the JAX package's compiler.  Where Mamba.jl re-walks the DAG
and differentiates by finite differences (src/model/simulation.jl:47-90),
the graph is resolved **once** here into functions over a ``state`` dict
(site name -> constrained value tensor of ONE chain); the engine batches
them over the chain axis with ``torch.func.vmap`` and takes exact gradients
with ``torch.func.grad_and_value``.  Each block function sums only the
log-density terms its parameters touch (reference block pruning,
model.jl:185-205).

Spaces: the canonical state holds *constrained* values (like the reference's
node values).  Each sampler block declares ``transform``: True means the
block's flat vector lives in unconstrained space with log-Jacobian terms
added for the block's own sites (reference transformdistribution.jl), False
means the flat vector is the raw constrained values with hard support
masking to -inf (reference distributionstruct.jl:138-140).

Node functions run under ``with torch.device(cm.device)``, so a model
lambda's fresh tensors (``torch.zeros(G)``) land beside the state.

Under a mesh with data axes (``comm.data_size > 1``) each data rank holds
and evaluates only its block (``parallel.mesh.DataGroup.block``) of the
arrays that ``site_specs`` names on the data axes, as GSPMD does in the
JAX package.  An array's **layout** is ``{dim: axes}``: each dim it is cut
on, by the product of its axes' sizes (a spec's tuple entry, its first
axis major).  "Slice" below is a rank's block under a layout; "the data
group" is every rank that shares the rank's chain rank:

- ``inputs`` hold the rank's slice of every named input;
- the chain-stacked state holds the slice of every named data site
  (observed, or imputed by MISS) and of every named *sampled* site that
  the rank can hold in part (``_held``, ``local_state``): each block that
  samples it can hold slices (NUTS, ChEES-HMC, HMC and MALA with unit
  mass: ``SamplerSpec.holds_slices``) and the probe below finds it read
  only as its slice.  Such a block's flat vector, momentum, gradient and
  per-coordinate tunes are the rank's coordinates (``block_coords``: their
  place in the unsharded flat vector, and the sums over them completed
  over the data group).  Any other named sampled site stays whole in the
  state, as the samplers of its blocks read it, and the density's env
  holds its slice (``_whole_reasons`` says why);
- logical nodes are computed from the slices: a node that reads only
  slices and whole values may come out a slice (line's ``mu = xmat @
  beta``); which nodes do, and along which dim, is found at compile time.

A value cut over a set S of the data axes is held alike by the ranks
that differ on the other data axes only, and counts once: on the ranks at
index 0 of every data axis outside S (``_counts``).  A rank's block
density sums its part of every named term it counts (the slice's terms,
padding masked out), the Jacobian of the slices it maps and counts, and,
on data rank 0 alone, every other term and the Jacobian of the whole
sites: the parts sum to the density over the data group (``logpdf``).  A
block call is completed by one all-reduce over the data group
(``block_sum``): of the value and the whole coordinates' gradient where
the block holds slices, else of the value and the whole gradient; a slice
coordinate's gradient is the rank's own, summed over the data axes its
site is replicated on (one all-reduce per such set of axes: rats'
``alpha``, cut by rat, over ``week``).  To
know the parts are right, the compiler evaluates the graph at a probe
state once whole and once on every rank's slices (every block of the
group), all on this host (every rank is given whole inputs), and refuses,
naming the node, a model whose named
terms' parts do not sum to the term or whose unnamed terms change on a
slice, where none of the resolutions below confirms them; a named
sampled site is held in
part only if each slice's bijector maps its slice as the whole bijector
maps the whole and their Jacobians sum to the whole's.  The probe state
draws every
sampled site and every missing data entry from a fixed generator, so its
values are distinct and finite where the example inits may be symmetric
(rats' ``alpha`` all 250) or NaN, and a node that reads a slice where it
needs the whole cannot agree by chance.  Only then does the rank drop the
slices it does not hold.  Whatever reads a whole value that a rank holds
in part gathers it over the data group (``whole``), and ``forward_sample``
draws a named site at its whole shape, from the unsharded run's stream,
and keeps the slice.

What GSPMD computes whole and a slice cannot, the compiler resolves where
it can, in topo order on the slices:

- a node or term that fails on the slices, or whose parts the probe does
  not confirm, may read a whole parent that the rank computes from whole
  state values and constants as the rank's slice of it (``_cuts``): each
  way of cutting such parents along a dim whose length is the whole
  length of a data dim the node reads is tried, fewest cuts first, and
  kept where the parts hold at the probe (the GLMM with only y and its
  covariates named: y reads the rank's slice of the whole b);
- a logical that comes out neither whole nor a slice ("mixed") but reads
  only constants (inputs, data with no missing entry: ``mean(y)``) is
  evaluated whole once, before the rank drops its slices (``_consts``);
  one that reads only whole state values and constants (``alpha -
  mean(alpha)`` of a named sampled site, whole in the state) is computed
  from the whole values (``_recut``), so such a site stays whole in the
  state.  Each is then whole on the rank, or cut where the slices' shape
  says a reader wants its slice;
- a mixed node that a density term reads and that reads the chain state
  and slices (``ss = sum((y - mu)**2)``, ``mean(y)`` of a y that MISS
  imputes) is gathered (``_gathered``): every rank computes it whole from
  its leaves, the nodes it reads in part, gathered over the data group
  with their padded tails dropped (``with_wholes``).  Where such a node
  reads a slice computed from another gathered node (``h = mu -
  mean(mu)``), that slice is no leaf: its own parents held in part are,
  and it is computed whole on the way (``_paths``).  A block that does not
  move the leaves gathers them once per step, before it
  (``block_prepare``), and a captured step loads them with the state; a
  block that moves them gathers them once per density call
  (``block_density``): the rank's slices from the flat vector, one
  all-gather, the density's gradient in the gathered leaves, and the
  rank's own slice of it pulled back to the flat vector.  Each rank's
  gradient there is that of the terms it counts (a named term's part, as
  the sum-to-zero effect ``b = sqrt(s2) * (z - mean(z))`` that each
  rank's y reads its groups of, and on data rank 0 every other term), so
  one all-reduce over the data group sums them first, as GSPMD transposes
  an all-gather;
- a named site whose data dims cut an event of its law along a dim the
  law does not split (``_cuts_an_event``: jaws' one 80-long
  ``BDiagNormal`` event cut by boy) is a whole term (``_whole_terms``), as
  GSPMD gathers the event: computed from the whole values of what it
  reads in part (a constant's fixed at compile time, a sampled site's
  from its whole value in the state, any other gathered as a gathered
  node's leaves are) and counted on data rank 0.  A sampled site with a
  whole term stays whole in the state;
- a named sampled site whose prior reads a slice: each rank's part is its
  slice's ``log_prob`` and the Jacobian of its slice under the slice's
  bijector, where the data dim is a batch dim of its law (its rows) and
  the probe confirms that the slice's bijector maps the slice as the whole
  maps the whole.  Held in part, it is the rank's slice; whole in the
  state (``_part_sites``: a sampler that cannot hold slices), its pack and
  unpack map the slice and ``block_maps`` joins the slices over the data
  group;
- a named site with a law per row (a multivariate distribution whose
  batch dims hold the data dim) is cut along its batch (``_cut_dist``);
  one whose law's batch does not reach the data dim (birats' ``MvNormal(
  mu_beta, Sigma)`` recycled over the rows) is the law on the rank's rows;
- a mixed node read outside the vmapped density (a monitor, a Gibbs or
  custom block) is computed again from its parents' whole values
  (``monitor_rows``, ``WholeValues``).

A node resolved or gathered whole from an array that the data axis pads
(``pads``) is computed from the array as given, its padded tail dropped
(``_unpadded``, ``WholeValues``): its value is the unsharded run's, not
a count of the padding.  Which dims of a node hold padding is the node's
own record (``_padded``): an array's from ``pads``, a slice's from the
padded slices it reads (a dim of its layout as long as one of their
padded dims, cut by the same axes), which the probe confirms (moving the
arrays' padded tails moves no other entry), so a padded length that
another array has as given is no ambiguity.

What stays refused, each by a ValueError that names it: what
``NamedSharding`` refuses, a spec that names the chain axis or an axis on
two dims (``parallel.mesh.data_dim``), and anything whose parts the probe
cannot confirm against the whole, whatever the evaluation raised.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from ..ops import random as R
from ..ops.distributions.base import dist_flatten, keys_lead
from ..parallel.mesh import WHOLE, BlockCoords, DataGroup, MeshComm, data_dim
from ..utils.convert import to_tensor
from ..utils.pytree import RavelSpec, elementwise_names, make_ravel_spec
from .model import Model
from .nodes import LogicalNode, StochasticNode
from .whole import WholeValues


#: the seed of the generator that draws ``_plan_views``' probe state
PROBE_SEED = 0
#: the most ways ``_cut_options`` tries of reading whole parents cut
_MAX_CUTS = 64
#: what evaluating a node on a data slice may raise
_EVAL_ERRORS = (RuntimeError, ValueError, IndexError, TypeError)


class _Failed(Exception):
    """A reading of a term on the data slices that the probe does not
    confirm; ``error`` is the ValueError, naming the term, to raise if no
    other reading holds."""

    def __init__(self, error: ValueError):
        super().__init__(str(error))
        self.error = error


def _wkey(name: str) -> str:
    """The state key under which a data rank's state carries the whole
    (unpadded) value of ``name``, a parent of a gathered node."""
    return f"{name}@whole"


def default_dtype(device: torch.device) -> torch.dtype:
    """float64 on the CPU (how the tests run the reference), float32 on an
    accelerator (how the reference runs on its chip)."""
    return torch.float64 if device.type == "cpu" else torch.float32


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Static per-stochastic-site metadata resolved at compile time."""
    name: str
    shape: tuple[int, ...]
    unconstrained_shape: tuple[int, ...]


class CompiledModel:
    """Compile-once representation of (Model, inputs, example inits) on one
    device.  Inputs are held as tensors on that device; the dynamic state
    is a dict {site name -> constrained value tensor}.
    """

    def __init__(self, model: Model, inputs: dict[str, Any],
                 example_inits: dict[str, Any], *, device, dtype=None,
                 masks: dict[str, Any] | None = None,
                 comm: MeshComm | None = None, site_specs: dict | None = None,
                 pads: dict[str, dict[int, int]] | None = None):
        self.model = model
        self.device = torch.device(device)
        self.dtype = dtype or default_dtype(self.device)
        #: this rank's collectives over the run's mesh (none: the identity)
        self.comm = comm or MeshComm()
        #: the data axes as this rank sees them: its blocks under a layout
        self._geo = DataGroup(self.comm.data_axes, self.comm.data_shape,
                              self.comm.data_rank)
        #: per-site likelihood masks (True = real observation); masked-out
        #: entries contribute exactly 0 to every log density
        self.masks = {k: np.asarray(v, dtype=bool)
                      for k, v in (masks or {}).items()}
        #: the edge padding of a mesh's data axis (``mcmc``'s
        #: ``_pad_sharded``): per input or site, each padded dim's length as
        #: given
        self.pads = {k: dict(v) for k, v in (pads or {}).items()}
        missing = model.input_names - set(inputs)
        if missing:
            raise ValueError(f"missing input values for {sorted(missing)}")
        self.inputs = {k: self.tensor(v) for k, v in inputs.items()
                       if k in model.input_names}

        self.stochastic = model.keys("stochastic")
        self.logical = model.keys("logical")

        # ---- the data axes (``_plan_views``); empty without them --------
        #: every array named on the data axes: its layout (``{dim: axes}``)
        self._data_dims: dict[str, dict] = {}
        #: nodes this rank holds in part (named inputs, named observed
        #: sites, logicals that come out a slice): the slice's layout
        self.local_dims: dict[str, dict] = {}
        #: named sampled sites, whole in the state: the layout the
        #: density's env cuts
        self._env_dims: dict[str, dict] = {}
        #: named sampled sites this rank holds as its slice, in the state and
        #: in its blocks' flat vectors (module docstring): their layout
        self._held: dict[str, dict] = {}
        #: named sampled sites whole in the state: why each is not held
        self._whole_reasons: dict[str, str] = {}
        #: logical nodes that are neither whole nor a slice on a data rank
        self.mixed: frozenset = frozenset()
        #: this data rank's part of every named stochastic term
        #: (``_part_plan``)
        self._local_plans: dict[str, tuple] = {}
        #: per site held in part, or named sampled site, whose distribution
        #: reads slices: each parameter's layout (None: whole, -1:
        #: neither) and its ndim
        self._leaf_dims: dict[str, list] = {}
        #: named sampled sites whose prior reads slices, whole in the state
        #: (not ``_held``): the layout of the slice the density maps and
        #: sums (``block_functions``)
        self._part_sites: dict[str, dict] = {}
        #: logicals that read only constants (inputs, data with no missing
        #: entries), evaluated whole once: (the rank's value, the whole)
        self._consts: dict[str, tuple] = {}
        #: logicals that read only whole state values and constants,
        #: computed from the whole values: the layout the env cuts (None:
        #: whole)
        self._recut: dict[str, dict | None] = {}
        #: the data sites a constant reads: every chain's init must hold
        #: the example's value (``mcmc``'s ``_chain_inits`` checks)
        self.const_data: frozenset = frozenset()
        #: per node or term, the whole parents it reads as the rank's slice
        #: of them: the layout each is cut by (one dim)
        self._cuts: dict[str, dict[str, dict]] = {}
        #: mixed nodes that a density term reads, computed whole on every
        #: rank from leaves gathered over the data group: per node, the
        #: leaves it reads in part and their layouts (``_gathered_parents``)
        self._gathered: dict[str, dict[str, dict]] = {}
        #: every node gathered over the data group (the leaves of the
        #: gathered nodes and of the whole terms): its layout
        self._gather_dims: dict[str, dict] = {}
        #: per gathered node, the slices between it and its leaves, computed
        #: whole on the way, in topo order (``_gathered_parents``)
        self._paths: dict[str, list] = {}
        #: named sites whose data dims cut an event of their law: per term,
        #: the nodes it reads in part (itself among them), whose whole
        #: values it is computed from (``_node_dist``, ``_term_value``)
        self._whole_terms: dict[str, dict] = {}
        #: the whole values of the constants that a whole term reads in
        #: part, fixed at compile time, keyed by ``_wkey``
        self._fixed_wholes: dict = {}
        #: named sampled sites, whole in the state, that a whole term reads
        self._state_wholes: frozenset = frozenset()
        #: per node that holds padding along a data dim: each such dim's
        #: (length as given, padded length), from ``pads`` for an array, from
        #: the padded slices it reads for a slice (``_slice_padding``), and
        #: from its shape for a node computed whole (``_pad_back``)
        self._padded: dict[str, dict[int, tuple[int, int]]] = {}
        #: the gathered nodes' leaves' whole values at the example inits
        self._example_wholes: dict = {}
        # --- resolve shapes / bijectors with one eager forward pass -------
        state = {}
        for name in self.stochastic:
            if name not in example_inits:
                raise ValueError(f"no initial value for stochastic node {name!r}")
            state[name] = self.tensor(np.asarray(example_inits[name],
                                                 dtype=np.float64))
        env = self._eval_env(state)
        dists = {n: self._node_dist(n, env) for n in self.stochastic}
        #: concrete example distributions (bijector resolution, support
        #: metadata)
        self.example_dists = dists
        #: every node's value at the example inits, as numpy (NaN entries of
        #: an observed node mark its missing values)
        self.example_values = {n: v.detach().cpu().numpy()
                               for n, v in env.items()}
        self.sites: dict[str, SiteSpec] = {}
        for name in self.stochastic:
            shape = tuple(env[name].shape)
            self.sites[name] = SiteSpec(
                name=name, shape=shape,
                unconstrained_shape=tuple(
                    dists[name].bijector().unconstrained_shape(shape)))
        # logical node shapes (for monitors)
        self.logical_shapes = {n: tuple(env[n].shape) for n in self.logical}
        self._block_cache: dict = {}
        #: how ``_site_lp`` applies each mask (``_mask_plan``)
        self._plans = {n: self._mask_plan(n, dists[n], m)
                       for n, m in self.masks.items()}
        for spec in (site_specs or {}).values():   # the refusals, on any mesh
            data_dim(spec, self.comm.data_axes, self.comm.chain_axis)
        if self.comm.data_size > 1 and site_specs:
            self._plan_views(site_specs, state)

    def tensor(self, v) -> torch.Tensor:
        """A value as a tensor on this model's device: floating values in
        the model's dtype, others keep their kind."""
        return to_tensor(v, self.device, self.dtype)

    # ---- graph evaluation ---------------------------------------------
    def _call(self, node, env):
        cut = self._cuts.get(node.name)
        with torch.device(self.device):
            if cut:
                return node.fn(*[self._block(env[d], cut[d]) if d in cut
                                 else env[d] for d in node.deps])
            return node.fn(*[env[d] for d in node.deps])

    def _eval_env(self, state: dict) -> dict:
        """All node values: inputs + stochastic state + logicals in topo
        order (on a data axis, this rank's env: module docstring)."""
        env = {**self.inputs, **self._fixed_wholes}
        env.update({n: self._env_value(n, v) for n, v in state.items()})
        env.update({_wkey(n): state[n] for n in self._state_wholes
                    if n in state})
        wenv = self._whole_env(state)
        for name in self.model.topo:
            node = self.model.nodes[name]
            if isinstance(node, LogicalNode):
                env[name] = self._logical(name, node, env, wenv)
        return env

    def _whole_env(self, state: dict, skip=()):
        """The whole values a recut logical reads that the env holds cut
        (the named sampled sites of ``state``), or None without recut
        logicals."""
        if not self._recut:
            return None
        return {n: state[n] for n in self._env_dims
                if n in state and n not in skip}

    def _logical(self, name: str, node, env: dict, wenv):
        """A logical node's value in a rank's env (module docstring): a
        constant's stored value; a recut node computed from the whole
        values ``wenv`` and cut; a gathered node computed whole from its
        leaves' whole values where the env carries them (``_wkey``), the
        slices between them computed whole on the way (``_paths``); any
        other from ``env``.  Keeps in ``wenv`` the whole value of a
        constant or recut node."""
        leaves = self._gathered.get(name)
        if leaves and all(_wkey(d) in env for d in leaves):
            done: dict = {}
            with torch.device(self.device):
                for m in (*self._paths.get(name, ()), name):
                    done[m] = self.model.nodes[m].fn(*[
                        done[d] if d in done else env[_wkey(d)]
                        if d in leaves else env[d]
                        for d in self.model.nodes[m].deps])
            return done[name]
        if name in self._consts:
            value, whole = self._consts[name]
            if wenv is not None:
                wenv[name] = whole
            return value
        if name in self._recut:
            whole = self._call_with(node, env, wenv)
            wenv[name] = whole
            layout = self._recut[name]
            return whole if layout is None else self._block(whole, layout)
        return self._call(node, env)

    def _call_with(self, node, env, wenv):
        with torch.device(self.device):
            return node.fn(*[wenv[d] if d in wenv else env[d]
                             for d in node.deps])

    def _node_dist(self, name: str, env: dict):
        """Stochastic ``name``'s distribution in ``env``: a whole term's
        (``_whole_terms``) from the whole values, without their padded
        tails, of what it reads in part."""
        node = self.model.nodes[name]
        parts = self._whole_terms.get(name)
        if parts is None:
            return self._call(node, env)
        with torch.device(self.device):
            return node.fn(*[self._trim(env[_wkey(d)], d) if d in parts
                             else env[d] for d in node.deps])

    def _term_value(self, name: str, env: dict):
        """The value that stochastic ``name``'s term scores in ``env``: a
        whole term's whole value without its padded tail."""
        if name in self._whole_terms:
            return self._trim(env[_wkey(name)], name)
        return env[name]

    def node_dist(self, name: str, state: dict):
        """Distribution of a stochastic node given ONE chain's state."""
        return self._node_dist(name, self._eval_env(state))

    def stacked_node_dist(self, name: str, state: dict):
        """Distribution of a stochastic node given a chain-stacked state: the
        node functions run under ``vmap`` and the distribution is rebuilt
        from its chain-stacked parameters, chain axis first."""
        rebuild = []

        def leaves(st):
            dist = self.node_dist(name, st)
            flat, re = dist_flatten(dist)
            rebuild.append(re)
            if dist.event_ndim == 0:
                # one rank for every parameter, so that they still broadcast
                # against each other once each has the chain axis in front
                rank = max((t.dim() for t in flat), default=0)
                flat = [t.reshape((1,) * (rank - t.dim()) + tuple(t.shape))
                        for t in flat]
            return tuple(flat)

        stacked = torch.func.vmap(leaves)(state)
        return rebuild[0](stacked)

    # ---- masks and the data axis ---------------------------------------
    def _mask_plan(self, name: str, dist, mask):
        """How ``_apply`` applies ``mask`` (None: no mask) to the values of
        site ``name`` under ``dist``:

        - ``("entries", m)``: ``m`` over the entries of ``log_prob``;
        - ``("events", m)``: the mask covers event dims and takes each event
          whole or not at all; ``m`` over the events;
        - ``("range", lo, hi, consts, vlo)``: it takes the events' entries
          lo..hi-1 along the dim that the distribution can split its event
          on (``event_split_dim``, e.g. the fused GLMM's groups), whole
          along the others; ``consts`` is ``dist.split_constants(lo, hi)``,
          cut once here, and the range's values start at ``vlo`` of the
          value's split dim.

        Any other mask over event dims raises: summing part of an event is
        not that event's density, and an event is not dropped silently."""
        if mask is None:
            return None
        lp_ndim = mask.ndim - dist.event_ndim
        if dist.event_ndim <= 0:
            return ("entries", torch.as_tensor(mask, device=self.device))
        ev = mask.reshape(mask.shape[:lp_ndim] + (-1,))
        if np.all(ev.all(-1) | ~ev.any(-1)):
            return ("events", torch.as_tensor(ev.all(-1), device=self.device))
        split = getattr(dist, "event_split_dim", None)
        if split is not None and lp_ndim == 0:
            other = tuple(d for d in range(mask.ndim) if d != split)
            whole, some = mask.all(axis=other), mask.any(axis=other)
            idx = np.flatnonzero(whole)
            if (np.array_equal(whole, some) and idx.size
                    and idx[-1] - idx[0] + 1 == idx.size):
                lo, hi = int(idx[0]), int(idx[-1]) + 1
                return ("range", lo, hi, dist.split_constants(lo, hi), lo)
        raise ValueError(
            f"the mask of site {name!r} takes part of an event of its "
            f"{type(dist).__name__} (event dims {dist.event_ndim}); a mask "
            f"must take each event whole or not at all"
            + ("" if split is None else
               f", or a contiguous range along event dim {split}"))

    def _plan_views(self, site_specs: dict, example: dict) -> None:
        """Find what each data rank holds and sums (module docstring), check
        the parts against the whole at the probe state (``_probe_state``
        of the ``example`` state), keep this rank's slices and drop the
        rest."""
        comm, geo = self.comm, self._geo
        size, nodes = comm.data_size, self.model.nodes
        dims = {}
        for name, spec in site_specs.items():
            if name not in self.inputs and name not in example:
                continue
            layout = geo.layout(data_dim(spec, comm.data_axes, comm.chain_axis))
            if not layout:
                continue
            shape = tuple((self.inputs.get(name, example.get(name))).shape)
            for dim, axes in layout.items():
                if dim >= len(shape):
                    raise ValueError(f"site spec {spec} of {name!r} names "
                                     f"dim {dim}, but its value has shape "
                                     f"{shape}")
                if shape[dim] % geo.count(axes):
                    raise ValueError(f"dim {dim} of {name!r} ({shape[dim]}) "
                                     f"does not divide over the data axes "
                                     f"{axes}")
            dims[name] = layout
        if not dims:
            return
        self._data_dims = dims
        padded = self._padded = self._array_pads(dims, example)
        tol = torch.finfo(self.dtype).eps ** 0.5
        example_env = self._eval_env(example)
        state = self._probe_state(example)
        arrays = {**self.inputs, **state}

        def cut(name, x, k):
            return geo.block(x, dims[name], k)

        # the graph whole and on every slice, on this host, in topo order:
        # how each node's slices relate to its whole value (``_classify``).
        # ``whole`` holds the unsharded run's values: a node that is neither
        # whole nor a slice ("mixed") is computed from its parents with the
        # padded tails dropped (``_unpadded``).  A mixed node that reads
        # only constants (``const``) or only whole state values and
        # constants (``run_whole``) is resolved: its whole value, cut where
        # the slices' shape says (``_cut_layout``), as the rank will hold it.
        # Any other that a density term reads is gathered: every rank
        # computes it whole from its leaves gathered over the data group.
        # A node or term that fails on the slices, or comes out mixed, may
        # read a whole parent as the rank's slice of it (``_cut_options``).
        # A named term whose data dims cut an event of its law is computed
        # whole (``_whole_terms``).  A slice's padding (``_padded``) is
        # that of the padded slices it reads, dim by dim
        # (``_slice_padding``); ``shaken`` holds the floating padded arrays
        # with their padded tails moved, and the slices computed from them,
        # which confirm it (``_shaken``)
        data = self._data_sites()
        observed = set(self.model.keys("observed"))
        read_by_terms = _reads(self.model, self.stochastic)
        const = {n: True for n in self.inputs}
        run_whole = {n: n not in dims for n in self.inputs}
        whole = dict(arrays)
        shaken = {n: _shake(whole[n], rec) for n, rec in padded.items()
                  if whole[n].is_floating_point()}
        envs = [{n: cut(n, v, k) if n in dims else v
                 for n, v in arrays.items()} for k in range(size)]
        sliced, mixed, resolved, reads = dict(dims), set(), {}, {}
        cuts, gathered, plans, dists, paths = {}, {}, {}, {}, {}
        whole_terms = self._whole_terms = {}
        part_dists = [{} for _ in range(size)]
        for name in self.model.topo:
            node = nodes[name]
            options = self._cut_options(name, node, whole, sliced, run_whole,
                                        gathered)
            if isinstance(node, LogicalNode):
                const[name] = all(const[d] for d in node.deps)
                run_whole[name] = all(run_whole[d] for d in node.deps)
                value = self._call(node, whole)
                parts, how, cut_ = self._slices_of(name, node, value, envs,
                                                   options, tol)
                if cut_:
                    cuts[name] = cut_
                if isinstance(how, dict):
                    rec = self._slice_padding(name, node, how, value, sliced)
                    if rec:
                        padded[name] = rec
                    if any(d in shaken for d in node.deps):
                        shaken[name] = self._shaken(name, node, value, rec,
                                                    {**whole, **shaken})
                if how == "mixed":
                    unpadded = self._unpadded(node, whole)
                    if unpadded is not None:
                        value = self._pad_back(name, unpadded,
                                               tuple(value.shape))
                    if const[name] or run_whole[name]:
                        d = _cut_layout(value, parts, geo)
                        if d is not False:
                            resolved[name] = d
                            how = d
                            parts = [value if d is None else
                                     geo.block(value, d, k)
                                     for k in range(size)]
                    if how == "mixed" and name in read_by_terms:
                        gathered[name] = self._gathered_parents(
                            name, node, sliced, gathered, paths)
                        # computed whole from the leaves as given: the
                        # unsharded run's value, which its readers read
                        if unpadded is not None:
                            value = unpadded
                        parts = [value] * size
                whole[name] = value
                for e, part in zip(envs, parts):
                    e[name] = part
                if how == "mixed":
                    mixed.add(name)
                elif how is not None:
                    sliced[name] = how
                continue
            reads[name] = sorted(d for d in node.deps
                                 if d in sliced or d in mixed)
            dists[name] = self._call(node, whole)
            pds, plan, cut_ = self._check_term(
                name, node, dists[name], state[name], envs, options,
                reads[name], data, tol)
            if cut_:
                cuts[name] = cut_
                reads[name] = sorted(set(reads[name]) | set(cut_))
            if plan == "whole":
                whole_terms[name] = {**{d: sliced[d] for d in node.deps
                                        if d in sliced}, name: dims[name]}
                self._check_whole_term(name, whole)
            elif plan is not None:
                plans[name] = plan
            for k, pd in enumerate(pds):
                part_dists[k][name] = pd
            const[name] = (name in observed
                           and not bool(torch.isnan(example[name]).any()))
            run_whole[name] = not (name in dims
                                   and (name in data or reads[name]))
        observed = data
        # keep this rank's slices, as copies that own their memory
        owned = {n: d for n, d in resolved.items() if const[n]}
        self._consts = {
            n: (whole[n] if d is None else geo.block(whole[n], d)
                .clone(memory_format=torch.contiguous_format), whole[n])
            for n, d in owned.items()}
        recut = {n: d for n, d in resolved.items() if n not in owned}
        # a slice that a recut logical reads is computed from whole state
        # values and constants too: it is recut as well (whole once, then cut)
        recut.update({n: sliced[n] for n in _reads(self.model, recut)
                      if n in self.logical_shapes and n in sliced
                      and n not in resolved})
        self._recut = recut
        self._held, self._whole_reasons = self._held_sites(
            dims, data, recut, plans, state, dists, part_dists, tol)
        self._part_sites = {n: dims[n] for n in dims
                            if n in self.sites and n not in data and reads[n]
                            and n not in self._held and n not in whole_terms}
        # what a whole term reads in part: a constant's whole value is
        # fixed now, a sampled site whole in the state is read there, and
        # any other is gathered, as a gathered node's leaves are
        fixed, gather = {}, {}
        for t, parts_ in whole_terms.items():
            for n, d in parts_.items():
                if const[n]:
                    fixed[n] = self._trim(example_env[n], n).clone(
                        memory_format=torch.contiguous_format)
                elif not (n in self.sites and n not in data
                          and n not in self._held
                          and n not in self._part_sites):
                    gather[n] = d
        self._fixed_wholes = {_wkey(n): v for n, v in fixed.items()}
        self._state_wholes = frozenset(
            n for parts_ in whole_terms.values() for n in parts_
            if n not in fixed and n not in gather)
        self.const_data = frozenset(
            n for n in (*_reads(self.model, owned), *fixed) if n in self.sites)
        for n, d in self._part_sites.items():
            why = self._maps_slices(d, plans[n], state[n], dists[n],
                                    [p[n] for p in part_dists], tol)
            if why:
                raise ValueError(
                    f"sampled site {n!r} is named on the data axis and its "
                    f"{type(dists[n]).__name__} reads {reads[n]}, which a "
                    f"data rank holds in part, but {why}")
        self._cuts = cuts
        self._gathered = gathered
        self._paths = {n: p for n, p in paths.items() if p}
        self._gather_dims = {**{p: d for g in gathered.values()
                                for p, d in g.items()}, **gather}
        self.inputs = {n: geo.block(v, dims[n]).clone(
                           memory_format=torch.contiguous_format)
                       if n in dims else v for n, v in self.inputs.items()}
        self.local_dims = {n: d for n, d in sliced.items()
                           if n not in self.sites or n in observed
                           or n in self._held}
        self._env_dims = {n: d for n, d in sliced.items()
                          if n in self.sites and n not in self.local_dims}
        self.mixed = frozenset(mixed)
        self._example_wholes = {_wkey(p): self._trim(example_env[p], p)
                                for p in self._gather_dims}
        local_env = self._eval_env({**self.cut_state(example, lead=0),
                                    **self._example_wholes})
        self.example_dists = {n: self._node_dist(n, local_env)
                              for n in self.stochastic}
        self._local_plans = {n: self._part_plan(n, comm.data_rank,
                                                self.example_dists[n],
                                                dists[n], reads[n], observed)
                             for n in dims
                             if n in self.sites and n not in whole_terms}
        self._leaf_dims = {
            n: _leaf_dims(dists[n], [d[n] for d in part_dists], tol, geo)
            for n in (*self.local_state, *self._part_sites)
            if reads[n] and n not in whole_terms}
        # the whole-mask plans of named sites hold whole constants; a whole
        # term's mask is its mask without the padded tail
        self._plans = {n: p for n, p in self._plans.items() if n not in dims}
        for t in whole_terms:
            mask = self.masks.get(t)
            if mask is not None:
                mask = self._trim(torch.as_tensor(mask), t).numpy()
                if not mask.all():
                    self._plans[t] = self._mask_plan(
                        t, self.example_dists[t], mask)

    def _array_pads(self, dims: dict, example: dict) -> dict:
        """Per array named on the data axes that the axes pad (``pads``):
        each padded dim's (length as given, padded length)."""
        out = {}
        for n, layout in dims.items():
            shape = tuple((self.inputs.get(n, example.get(n))).shape)
            rec = {d: (g, shape[d]) for d, g in self.pads.get(n, {}).items()
                   if d in layout and g != shape[d]}
            if rec:
                out[n] = rec
        return out

    def _slice_padding(self, name, node, how: dict, value, sliced) -> dict:
        """The padding of slice ``name`` (layout ``how``, whole ``value``)
        from the slices it reads (``sliced``): each dim of its layout whose
        length is the padded length of a padded dim of one of them, cut
        by the same data axes, carries that dim's padding (``{dim: (given,
        padded length)}``).  Raises, naming it, where two such dims differ
        in their length as given."""
        out = {}
        for dim, axes in how.items():
            recs = {rec for d in node.deps if d in sliced
                    for pd, rec in self._padded.get(d, {}).items()
                    if sliced[d].get(pd) == axes
                    and rec[1] == value.shape[dim]}
            if len(recs) > 1:
                raise ValueError(
                    f"dim {dim} of node {name!r} is cut by the data axes "
                    f"{axes} beside padded dims of lengths as given "
                    f"{sorted(g for g, _ in recs)}: its padding cannot be "
                    f"told apart")
            if recs:
                out[dim] = recs.pop()
        return out

    def _shaken(self, name, node, value, rec: dict, env: dict):
        """Slice ``name``'s value in ``env``, where the padded arrays'
        tails are moved (``_shake``).  Raises, naming it, where that cannot
        be evaluated or moves an entry outside the padded tails of its
        record ``rec`` (``_slice_padding``): the probe cannot confirm its
        padding."""
        try:
            moved = self._call(node, env)
        except _EVAL_ERRORS as e:
            raise ValueError(
                f"node {name!r} is a slice of arrays the data axes pad, and "
                f"it cannot be evaluated with their padded tails moved, "
                f"which confirms its padding: {e}") from e
        if _moved_outside(value, moved, rec):
            raise ValueError(
                f"node {name!r} is a slice of arrays the data axes pad, and "
                f"entries outside its padded tails {rec} move with theirs: "
                f"its padding cannot be confirmed")
        return moved

    def _check_whole_term(self, name: str, whole: dict) -> None:
        """Raise, naming it, unless whole term ``name`` is finite at the
        probe state ``whole``, computed from the whole values of what it
        reads in part without their padded tails (``_node_dist``)."""
        env = {**whole, **{_wkey(d): whole[d]
                           for d in self._whole_terms[name]}}
        try:
            lp = self._apply(None, self._node_dist(name, env),
                             self._term_value(name, env))
        except _EVAL_ERRORS as e:
            raise ValueError(
                f"the density of {name!r}, whose data dims cut an event of "
                f"its law, cannot be computed whole from the whole values "
                f"of what it reads in part: {e}") from e
        if not torch.isfinite(lp):
            raise ValueError(
                f"the density of {name!r}, computed whole, is {float(lp)} at "
                f"the probe state")

    def _trim(self, x, name: str, lead: int = 0):
        """``x``, a value of node ``name`` (``lead`` dims before its own),
        without the padded tail of each dim that its record of padding
        (``_padded``) names: the unsharded run's value.  ``x`` itself where
        it has no padding (a value already trimmed among them)."""
        for dim, (given, length) in self._padded.get(name, {}).items():
            if x.shape[lead + dim] == length:
                x = x.narrow(lead + dim, 0, given)
        return x

    def trim(self, name: str, x, lead: int = 0):
        """The whole value ``x`` of node ``name`` without the entries the
        data axis padded (``lead`` dims before the node's own)."""
        return self._trim(x, name, lead)

    def pad_back(self, name: str, x, lead: int = 0):
        """A logical's whole value ``x`` computed from unpadded parents
        (``lead`` dims before its own), padded back to its shape."""
        return self._pad_back(name, x, self.logical_shapes[name], lead)

    def _pad_back(self, name: str, t, shape: tuple, lead: int = 0):
        """``t``, a node's value computed from unpadded parents, edge-padded
        back to its padded ``shape`` (``lead`` dims before the node's own)
        along each dim where the two differ by the padding of an array it
        reads; records the dims (``_padded``)."""
        have = tuple(t.shape[lead:])
        if have == tuple(shape):
            return t
        seen = {rec for n in self.padded_reads(name)
                for rec in self._padded.get(n, {}).values()}
        diff = [d for d in range(len(shape)) if len(have) == len(shape)
                and have[d] != shape[d]]
        if not diff or any((have[d], shape[d]) not in seen for d in diff):
            raise ValueError(
                f"node {name!r} is computed from arrays the data axes pad, "
                f"and its value without their padding is shaped {have}, "
                f"not its padded shape {tuple(shape)} less the padding")
        self._padded[name] = {d: (have[d], shape[d]) for d in diff}
        return _pad_tail(t, self._padded[name], lead)

    def _unpadded(self, node, whole: dict):
        """A mixed node's whole value as the unsharded run has it: computed
        from its parents with the padded tails dropped (``_trim``); None
        where it reads no padded array."""
        if not self.padded_reads(node.name):
            return None
        with torch.device(self.device):
            return node.fn(*[self._trim(whole[d], d) for d in node.deps])

    def _cut_options(self, name, node, whole, sliced, run_whole,
                     gathered) -> list:
        """The ways a node or term may read whole parents as the rank's
        slice of them, fewest cuts first: each parent that the rank
        computes whole from whole state values and constants
        (``run_whole``) or gathers, cut along one of its dims whose length
        is the whole length of a data dim the node reads (its own, for a
        named site), by that data dim's axes: a cut is ``{dim: axes}``."""
        lengths: dict = {}
        named = [(whole[d], sliced[d]) for d in node.deps if d in sliced]
        if name in self._data_dims and name in whole:
            named.append((whole[name], self._data_dims[name]))
        for value, layout in named:
            for dim, axes in layout.items():
                lengths.setdefault(tuple(value.shape)[dim], []).append(axes)
        opts = []
        for d in node.deps:
            if d in sliced or not (run_whole.get(d) or d in gathered):
                continue
            at = [{i: axes} for i, n in enumerate(tuple(whole[d].shape))
                  for axes in dict.fromkeys(lengths.get(n, ()))]
            if at:
                opts.append((d, at))
        out = []
        for choice in itertools.product(*[[None] + at for _, at in opts]):
            combo = {d: i for (d, _), i in zip(opts, choice) if i is not None}
            if combo:
                out.append(combo)
        return sorted(out, key=len)[:_MAX_CUTS]

    def _call_cut(self, node, env: dict, combo: dict, k: int):
        """``node`` on slice ``k``'s env, each parent of ``combo`` read as
        rank ``k``'s block under the layout ``combo`` gives."""
        geo = self._geo
        with torch.device(self.device):
            return node.fn(*[geo.block(env[d], combo[d], k)
                             if d in combo else env[d] for d in node.deps])

    def _slices_of(self, name, node, value, envs, options, tol):
        """A logical's values on the slices, how they relate to its whole
        ``value`` (``_classify``) and the parents it reads cut (``{}``:
        none).  Uncut first; where that fails or comes out mixed, each of
        ``options`` in turn, kept if it comes out whole or a slice."""
        error, parts = None, None
        try:
            parts = [self._call_cut(node, e, {}, k) for k, e in enumerate(envs)]
            how = _classify(value, parts, tol, self._geo)
            if how != "mixed":
                return parts, how, {}
        except _EVAL_ERRORS as e:
            error = e
        for combo in options:
            try:
                got = [self._call_cut(node, e, combo, k)
                       for k, e in enumerate(envs)]
            except _EVAL_ERRORS:
                continue
            how = _classify(value, got, tol, self._geo)
            if how != "mixed":
                return got, how, combo
        if parts is None:
            raise ValueError(
                f"node {name!r} cannot be evaluated on a data slice of the "
                f"arrays that site_specs names: {error}") from error
        return parts, "mixed", {}

    def _check_term(self, name, node, dist, value, envs, options, reads,
                    data, tol):
        """Check stochastic ``name``'s term on the slices against the whole
        at the probe state: a named term's parts sum to it, an unnamed one
        is the same on every slice.  Uncut first, then each of ``options``
        (``_cut_options``).  Returns the slices' distributions, a named
        term's plan per rank (``_part_plan``) and the parents read cut.  If
        none holds, a named term whose data dims cut an event of its law
        (``_cuts_an_event``) is computed whole (the plan ``"whole"``); any
        other raises the uncut reading's error, naming ``name``."""
        size = self.comm.data_size
        whole_lp = self._site_lp(name, dist, value)
        if not torch.isfinite(whole_lp):
            raise ValueError(
                f"the density of {name!r} is {float(whole_lp)} at the "
                f"probe state (module docstring), so the data ranks' "
                f"parts of the model cannot be checked there")
        named = name in self._data_dims

        def attempt(combo):
            r = sorted(set(reads) | set(combo))
            try:
                pds = [self._call_cut(node, e, combo, k)
                       for k, e in enumerate(envs)]
            except _EVAL_ERRORS as e:
                raise _Failed(ValueError(
                    f"the density of {name!r} cannot be evaluated on a data "
                    f"slice of the arrays that site_specs names: {e}")) from e
            if not named:
                try:
                    same = all(_lp_close([self._site_lp(name, pd, value)],
                                         whole_lp, tol) for pd in pds)
                except _EVAL_ERRORS:
                    same = False
                if not same:
                    raise _Failed(ValueError(
                        f"the density of {name!r}, which site_specs does "
                        f"not name, changes on a data slice: it reads "
                        f"{r}, which a data rank holds in part (or "
                        f"computes from a part).  Name {name!r} in "
                        f"site_specs, or compute what it reads from "
                        f"whole values"))
                return pds, None
            try:
                plans = [self._part_plan(name, k, pds[k], dist, r, data)
                         for k in range(size)]
            except ValueError as e:
                raise _Failed(e) from e
            layout = self._data_dims[name]
            try:
                parts = [self._part_lp(plans[k], pds[k],
                                       self._geo.block(value, layout, k))
                         for k in range(size)
                         if self._geo.leads(layout, k)]
            except _EVAL_ERRORS as e:
                raise _Failed(ValueError(
                    f"the density of {name!r} cannot be evaluated on a data "
                    f"slice of the arrays that site_specs names: {e}")) from e
            if not _lp_close(parts, whole_lp, tol):
                raise _Failed(ValueError(
                    f"the parts of {name!r}'s density on the data slices do "
                    f"not sum to its density: its distribution reads {r}, "
                    f"which a data rank holds in part (or computes from a "
                    f"part)"))
            return pds, plans

        try:
            pds, plans = attempt({})
            return pds, plans, {}
        except _Failed as f:
            first = f.error
        for combo in options:
            try:
                pds, plans = attempt(combo)
            except _Failed:
                continue
            return pds, plans, combo
        if named and self._cuts_an_event(name, dist):
            # GSPMD gathers the event: the term is computed whole
            return [dist] * size, "whole", {}
        raise first

    def _cuts_an_event(self, name: str, dist) -> bool:
        """Whether named site ``name``'s data dims cut an event of its law
        ``dist`` along a dim it does not split (``event_split_dim``, whose
        range of a rank is held to its slice's own)."""
        rows = len(self.sites[name].shape) - max(dist.event_ndim, 0)
        split = getattr(dist, "event_split_dim", None)
        return any(d >= rows and d != split for d in self._data_dims[name])

    def _gathered_parents(self, name, node, sliced, gathered, paths) -> dict:
        """The leaves that a gathered node reads in part (each with its
        layout): every rank gathers them over the data group and computes
        the node whole.  A parent held in part that is a slice computed
        from another gathered node is no leaf: its own parents held in part
        are, in turn, and it is computed whole on the way (``paths[name]``,
        in topo order), so that a per-call block's gradient flows back
        through it to the leaves."""
        leaves, between = {}, set()

        def visit(d):
            n = self.model.nodes.get(d)
            if not (isinstance(n, LogicalNode)
                    and _reads(self.model, [d]) & set(gathered)):
                leaves.setdefault(d, sliced[d])
            elif d not in between:
                between.add(d)
                for p in n.deps:
                    if p in sliced:
                        visit(p)
        for d in node.deps:
            if d in sliced:
                visit(d)
        paths[name] = [n for n in self.model.topo if n in between]
        return leaves

    def _held_sites(self, dims, data, recut, plans, state, dists, part_dists,
                    tol) -> tuple[dict, dict]:
        """The named sampled sites each data rank holds as its slice
        (``_held``): those that every sampler block sampling them can hold
        in part (``SamplerSpec.holds_slices``) and that the probe finds read
        only as slices.  No recut logical reads them (it is computed from
        the whole value), each rank's part of their density is its slice's
        own (a ``"local"`` or ``"cut"`` plan: ``plans``, per rank), their
        unconstrained shape keeps the data dim, and each slice's bijector
        maps the slice as the whole one maps the whole (``_maps_slices``).
        Any other stays whole in the state, as before, and the second dict
        says why (``_whole_reasons``)."""
        holds: dict[str, list] = {}
        for spec in self.model.samplers:
            for p in spec.params:
                holds.setdefault(p, []).append(spec)
        read_whole = _reads(self.model, recut)
        held, reasons = {}, {}
        for n, d in dims.items():
            if n not in self.sites or n in data:
                continue
            site = self.sites[n]
            cannot = sorted({type(s).__name__ for s in holds.get(n, ())
                             if not getattr(s, "holds_slices", False)})
            if n in self._whole_terms:
                reasons[n] = (f"its data dims cut an event of its "
                              f"{type(dists[n]).__name__}: its density is "
                              f"computed whole, from its whole value")
            elif not holds.get(n):
                reasons[n] = "no sampler block samples it"
            elif cannot:
                reasons[n] = (f"sampled by a block that cannot hold a slice "
                              f"({', '.join(cannot)})")
            elif n in read_whole:
                reasons[n] = "a logical computed from its whole value reads it"
            elif any(p[0] not in ("local", "cut") for p in plans[n]):
                reasons[n] = "a rank's part of its density is not its slice's"
            elif (len(site.unconstrained_shape) != len(site.shape)
                  or any(site.unconstrained_shape[i] != site.shape[i]
                         for i in d)):
                reasons[n] = ("its unconstrained shape does not keep the data "
                              "dim")
            else:
                why = self._maps_slices(d, plans[n], state[n], dists[n],
                                        [p[n] for p in part_dists], tol)
                if why:
                    reasons[n] = why
                else:
                    held[n] = d
        return held, reasons

    def _maps_slices(self, layout, plans, value, whole, parts, tol) -> str:
        """Why a site's bijector does not map each data rank's slice
        alone at the probe state ("" where it does): each slice's bijector
        (of the rank's distribution, cut by its plan) must take the slice
        of the whole unconstrained value to the slice of ``value`` and
        back, and the slices' Jacobians sum to the whole's.  A slice's
        distribution shaped beyond the slice (a parameter the data axis
        does not cut) does not map it.  Each slice's Jacobian counts once,
        on the ranks that count the site (``DataGroup.leads``)."""
        geo = self._geo
        ev = max(whole.event_ndim, 0)
        try:
            b = whole.bijector()
            u = b.inverse(value)
            logdets = []
            for k, (plan, part) in enumerate(zip(plans, parts)):
                dk = self._slice_dist(plan, part)
                uk = geo.block(u, layout, k)
                vk = geo.block(value, layout, k)
                shape = tuple(dk.batch_shape) + tuple(dk.event_shape)
                if not _fits(shape, tuple(vk.shape)):
                    return (f"data rank {k}'s distribution is shaped {shape}, "
                            f"beyond its slice's {tuple(vk.shape)}")
                bk = dk.bijector()
                if not (_close(bk.forward(uk), vk, tol)
                        and _close(bk.inverse(vk), uk, tol)):
                    return (f"its bijector on data rank {k}'s slice is not "
                            f"the whole's")
                if geo.leads(layout, k):
                    logdets.append(torch.sum(bk.event_log_det(uk, ev)))
            if not _lp_close(logdets, torch.sum(b.event_log_det(u, ev)), tol):
                return "its slices' Jacobians do not sum to the whole's"
        except _EVAL_ERRORS as e:
            return f"its bijector cannot map a data rank's slice alone ({e})"
        return ""

    def _slice_dist(self, plan, dist):
        """A data rank's distribution of a named site as its part reads it
        (``_part_plan``): cut to the slice under a ``"cut"`` plan."""
        if plan[0] == "cut":
            return self._cut_dist(dist, plan[1], plan[3])
        return dist

    def _slice_bijector(self, name: str, dist):
        """The bijector that maps this rank's slice of a named sampled
        site held in part (``_held``) or whose prior reads slices
        (``_part_sites``), from its distribution in the rank's env."""
        return self._slice_dist(self._local_plans[name], dist).bijector()

    def padded_reads(self, name: str) -> list:
        """The arrays that the data axis pads (``pads``) which node ``name``
        reads, directly or through another logical."""
        return sorted(n for n in _reads(self.model, [name]) if n in self.pads)

    def _probe_state(self, example: dict) -> dict:
        """The state at which ``_plan_views`` checks the parts: every
        sampled site drawn in unconstrained space (a standard normal
        mapped by its bijector; a discrete site from its distribution),
        and the missing (NaN) entries of a data site drawn from its
        distribution, in topo order, node ``i`` from ``fold_in(key(
        PROBE_SEED), i)``; data entries as ``example`` holds them.  Every
        rank draws the same values."""
        probe = R.key(PROBE_SEED, self.device)
        data = self._data_sites()
        env, out = dict(self.inputs), {}
        for i, name in enumerate(self.model.topo):
            node = self.model.nodes[name]
            if isinstance(node, LogicalNode):
                env[name] = self._call(node, env)
            elif name in self.sites:
                x = example[name]
                missing = torch.isnan(x)
                if name not in data or bool(missing.any()):
                    draw = self._probe_draw(name, self._call(node, env),
                                            R.fold_in(probe, i), name in data)
                    x = torch.where(missing, draw, x) if name in data else draw
                out[name] = env[name] = x
        return out

    def _probe_draw(self, name: str, dist, key, data: bool) -> torch.Tensor:
        """One probe value of site ``name`` under ``dist``: a draw from
        ``dist`` for data and discrete sites, else a standard normal in
        unconstrained space mapped by the bijector (a vague prior's own
        draws can overflow: InverseGamma(0.001, 0.001))."""
        site = self.sites[name]
        if data or dist.is_discrete:
            per = tuple(dist.batch_shape + dist.event_shape)
            value = dist.sample(key, site.shape[:len(site.shape) - len(per)])
            return value.expand(site.shape).to(self.dtype)
        u = R.normal(key, site.unconstrained_shape, self.dtype)
        return dist.bijector().forward(u)

    def _data_sites(self) -> set:
        """The stochastic sites that hold data: the observed ones, and
        those whose sampler only imputes their missing entries (MISS).  On
        a data axis a rank holds these in part, in the state too."""
        data = set(self.model.keys("observed"))
        for s in self.model.samplers:
            if getattr(s, "imputes_data", False):
                data.update(s.params)
        return data

    def _part_plan(self, name: str, k: int, part, whole, reads, observed):
        """Data rank ``k``'s part of the named term ``name``, given its
        distribution on the slice (``part``) and whole (``whole``):

        - ``("local", mask_plan)``: the distribution reads sliced values,
          so it is the slice's own (a law whose batch dims hold the data
          dims: its rows); or its batch does not reach the data dims,
          which recycles it over the value's leading dims (a law per row
          read whole: birats' ``MvNormal(mu_beta, Sigma)``); ``log_prob``
          of the slice;
        - ``("cut", cuts, mask_plan, rows)``: a distribution with whole
          parameters, each parameter cut, for each ``(from_right, lo, hi,
          length)`` of ``cuts``, to entries lo..hi-1 of a data dim of the
          site (``from_right`` dims from its last) where it has the dim's
          whole ``length``; ``rows``: a multivariate law per row (the data
          dims among its batch dims, its events whole), whose parameters
          carry event dims after them;
        - ``("range", lo, hi, consts, 0)``: a whole distribution whose one
          event splits along the one data dim (``_mask_plan``'s range, the
          slice's values starting at 0);
        - ``("zero",)``: the slice is all padding.

        ``mask_plan`` is ``_mask_plan`` of the slice's pad mask."""
        shape = self.sites[name].shape
        layout = self._data_dims[name]
        spans = {}
        for dim, (index, count) in self._geo.blocks(layout, k).items():
            per = shape[dim] // count
            spans[dim] = (index * per, (index + 1) * per)
        mask = self.masks.get(name)
        part_mask = None if mask is None else self._geo.block(mask, layout, k)
        if part_mask is not None and not part_mask.any():
            return ("zero",)
        rows = len(shape) - max(whole.event_ndim, 0)
        if reads:
            at = [d for d in layout if d >= rows]
            if name not in observed and at:
                raise ValueError(
                    f"sampled site {name!r} is named on the data axis at dim "
                    f"{at[0]}, an event dim of its {type(whole).__name__}, "
                    f"which reads {reads}, which a data rank holds in part: "
                    f"a slice of an event is not that event's density")
            return ("local", self._mask_plan(name, part, part_mask))

        def cuts(dims):
            return tuple((len(shape) - d, *spans[d], shape[d]) for d in dims)
        if whole.event_ndim <= 0:
            return ("cut", cuts(layout), self._mask_plan(name, whole, part_mask),
                    False)
        # a law per row: its batch dims hold the data dims, its events whole;
        # a batch that does not reach a data dim recycles the law over it
        batch = tuple(whole.batch_shape)
        cut, recycled = [], []
        for dim in layout:
            at = len(batch) - (rows - dim)
            if dim < rows and at >= 0 and batch[at] == shape[dim]:
                cut.append(dim)
            elif dim < rows and (at < 0 or batch[at] == 1):
                recycled.append(dim)
        if cut and len(cut) + len(recycled) == len(layout):
            return ("cut", cuts(cut), self._mask_plan(name, whole, part_mask),
                    True)
        if recycled and len(recycled) == len(layout):
            return ("local", self._mask_plan(name, whole, part_mask))
        dim = next(iter(layout)) if len(layout) == 1 else None
        if (dim is not None and len(shape) == whole.event_ndim
                and getattr(whole, "event_split_dim", None) == dim):
            lo, hi = spans[dim]
            take = np.zeros(shape, dtype=bool)
            take[(slice(None),) * dim + (slice(lo, hi),)] = True
            if mask is not None:
                take &= mask
            plan = self._mask_plan(name, whole, take)
            return plan[:4] + (plan[1] - lo,)
        raise ValueError(
            f"site {name!r} is named on the data axes at dims "
            f"{sorted(layout)}, but its {type(whole).__name__} reads only "
            f"whole values and cannot be cut there: name the arrays its "
            f"parameters come from on the data axes too, so that it is the "
            f"slice's own")

    def block_split(self, params: tuple[str, ...], prior_only: bool = False) -> bool:
        """Whether the block's density is split over the data axis: its
        ``logf`` on this rank is a part, and the data group's parts sum to
        the density.  A block that gathers a node once per density call
        (``block_gathers``) is split too: each rank's gradient holds its
        slice's share of the whole coordinates."""
        terms = tuple(params) if prior_only else self.block_terms(tuple(params))
        return (any(n in self._local_plans for n in terms)
                or self.block_gathers(params, prior_only) == "call")

    def block_gathers(self, params: tuple[str, ...],
                      prior_only: bool = False) -> str:
        """How the block's density gets the gathered nodes it reads
        (``_gathered``) and the whole terms' parts that are gathered
        (``_gather_reads``): ``""`` if it reads none; ``"step"`` if the
        block moves none of their leaves, which are then gathered once per
        block step, before it (``block_prepare``); ``"call"`` if it moves
        some, which are then gathered once per density call
        (``block_density``)."""
        params = tuple(params)
        read = self._gather_reads(params if prior_only
                                  else self.block_terms(params))
        if not read:
            return ""
        pset = set(params)

        def moves(p):
            return p in pset or (isinstance(self.model.nodes.get(p), LogicalNode)
                                 and bool(pset & _reads(self.model, [p])))
        return "call" if any(moves(p) for p in read) else "step"

    def _gather_reads(self, terms) -> set:
        """The gathered leaves (``_gather_dims``) that the terms ``terms``
        read: those of the gathered nodes they read, and the parts of the
        whole terms among them that are gathered."""
        out = set()
        for g in _reads(self.model, terms) & set(self._gathered):
            out.update(self._gathered[g])
        for t in terms:
            out.update(set(self._whole_terms.get(t, ())) & set(self._gather_dims))
        return out

    def block_sum(self, params: tuple[str, ...], prior_only: bool = False):
        """``f(value, grad=None) -> tuple`` that completes the block's
        vmapped ``logf`` values ``(C,)`` and gradients ``(C, rank dim)`` on
        this rank, with one all-reduce over the data group for a split
        block (the identity otherwise): of the value and the whole
        gradient, or, where the block holds slices (``block_coords``), of
        the value and the whole coordinates' gradient alone, ``(C, 1 +
        whole dim)``.  A slice coordinate's gradient is the rank's own
        where its site is cut over every data axis; one whose site is
        replicated over some data axes is summed over those (the ranks
        that hold it alike), one all-reduce per such set of axes, in a
        fixed order.  It is called on the outputs of ``torch.func.vmap``,
        never inside it."""
        if not self.block_split(params, prior_only):
            return _identity
        coords = self.block_coords(params)
        if prior_only or coords.index is None:
            return self.comm.data_sum
        whole, comm = coords.whole, self.comm
        replicated = self._replicated_positions(params)

        def complete(value, grad=None):
            if grad is None:
                return comm.data_sum(value)
            (head,) = comm.data_sum(torch.cat(
                [value[..., None], grad.index_select(-1, whole)], dim=-1))
            grad = grad.index_copy(-1, whole, head[..., 1:])
            for axes, at in replicated:
                (g,) = comm.data_sum(grad.index_select(-1, at), axes=axes)
                grad = grad.index_copy(-1, at, g)
            return head[..., 0], grad
        return complete

    def _replicated_positions(self, params) -> list:
        """The block's slice coordinates whose sites are replicated over
        some data axes, grouped by those axes: ``[(axes, positions in the
        rank's flat vector)]``, in the data axes' order."""
        spec = self.block_ravel_spec(tuple(params), True)
        geo, groups = self._geo, {}
        for p, o, n in zip(spec.names, spec.offsets, spec.sizes):
            if p not in self._held:
                continue
            cut = geo.axes_of(self._held[p])
            axes = tuple(a for a in geo.axes if a not in cut
                         and geo.sizes[a] > 1)
            if axes:
                groups.setdefault(axes, []).append(np.arange(o, o + n))
        order = sorted(groups, key=lambda axes: [geo.axes.index(a)
                                                 for a in axes])
        return [(axes, torch.as_tensor(np.concatenate(groups[axes]),
                                       device=self.device)) for axes in order]

    def block_coords(self, params: tuple[str, ...]) -> BlockCoords:
        """The block's flat coordinates on this data rank
        (``parallel.mesh.BlockCoords``) where it holds a site in part
        (``_held``): every data rank's positions in the unsharded
        unconstrained flat vector (the samplers that hold slices all
        transform), and this rank's whole coordinates.  ``WHOLE`` for a
        block that holds no slice."""
        if not any(p in self._held for p in params):
            return WHOLE
        key = ("coords", tuple(params))
        if key in self._block_cache:
            return self._block_cache[key]
        geo = self._geo
        full = make_ravel_spec(
            {p: np.zeros(self.sites[p].unconstrained_shape) for p in params},
            dtype=self.dtype)
        indices = []
        for k in range(self.comm.data_size):
            at = []
            for p, shape, offset, n in zip(full.names, full.shapes,
                                           full.offsets, full.sizes):
                ids = offset + np.arange(n).reshape(shape)
                if p in self._held:
                    ids = geo.block(ids, self._held[p], k)
                at.append(ids.reshape(-1))
            indices.append(torch.as_tensor(np.concatenate(at),
                                           device=self.device))
        spec = self.block_ravel_spec(tuple(params), True)

        def positions(keep):
            return torch.as_tensor(np.concatenate(
                [np.arange(o, o + n, dtype=np.int64) for p, o, n in
                 zip(spec.names, spec.offsets, spec.sizes) if keep(p)]
                + [np.zeros(0, dtype=np.int64)]), device=self.device)
        whole = positions(lambda p: p not in self._held)
        counted = positions(lambda p: p in self._held
                            and geo.leads(self._held[p]))
        out = BlockCoords(self.comm, indices, whole, full.total, counted)
        self._block_cache[key] = out
        return out

    # ---- full log density ---------------------------------------------
    def _apply(self, plan, dist, value, support_mask=True) -> torch.Tensor:
        """Total log density of ``value`` under ``dist``, honoring a mask
        plan (``_mask_plan``; masked entries contribute exactly 0, even if
        their values would be NaN/-inf)."""
        if plan is None:
            if support_mask:
                return dist.total_log_prob(value)
            return torch.sum(dist.log_prob(value))
        if plan[0] == "zero":
            return torch.zeros((), dtype=self.dtype, device=self.device)
        if plan[0] == "range":
            _, lo, hi, consts, vlo = plan
            at = (slice(None),) * dist.event_split_dim + (slice(vlo, vlo + hi - lo),)
            return dist.log_prob_range(value[at], lo, hi, consts)
        mask = plan[1]
        lp = dist.log_prob(value)
        if support_mask:
            lp = torch.where(dist.in_support(value), lp, -torch.inf)
        return torch.sum(torch.where(mask, lp, torch.zeros_like(lp)))

    def _site_lp(self, name: str, dist, value, support_mask=True) -> torch.Tensor:
        """Total log density of one whole site under its mask."""
        return self._apply(self._plans.get(name), dist, value, support_mask)

    @staticmethod
    def _cut_dist(dist, cuts, rows: bool = False):
        """A distribution cut, for each ``(from_right, lo, hi, length)`` of
        ``cuts``, to entries lo..hi-1 of a dim ``from_right`` dims from the
        value's last: every parameter that has the dim's whole ``length``
        there (by broadcasting) is cut.  ``rows``: the parameters may carry
        event dims of their own after it (a matrix per row), so the first
        such dim at or before that place is cut; the compiler's check of
        the parts at the probe state refuses a wrong cut."""
        leaves, rebuild = dist_flatten(dist)
        out = []
        for t in leaves:
            for from_right, lo, hi, length in cuts:
                first = t.dim() - from_right
                for ax in range(first, -1 if rows else first - 1, -1):
                    if ax >= 0 and t.shape[ax] == length:
                        t = t.narrow(ax, lo, hi - lo)
                        break
            out.append(t)
        return rebuild(out)

    def _part_lp(self, plan, dist, value, support_mask=True) -> torch.Tensor:
        """A data rank's part of a named term (``_part_plan``), from its
        distribution in the rank's env and its slice ``value``."""
        if plan[0] == "local":
            return self._apply(plan[1], dist, value, support_mask)
        if plan[0] == "cut":
            return self._apply(plan[2], self._cut_dist(dist, plan[1], plan[3]),
                               value, support_mask)
        return self._apply(plan, dist, value, support_mask)

    def logpdf_part(self, state: dict,
                    terms: tuple[str, ...] | None = None) -> torch.Tensor:
        """This data rank's part of ``logpdf``: its part of every named
        term it counts (``_counts``), and on data rank 0 every other term.
        Without a data axis, ``logpdf`` itself.  Vmappable; sum the parts
        over the data group outside ``vmap`` (``comm.data_sum``)."""
        env = self._eval_env(state)
        names = self.stochastic if terms is None else terms
        lp = torch.zeros((), dtype=self.dtype, device=self.device)
        for n in names:
            if not self._counts(n):
                continue
            if n in self._local_plans:
                lp = lp + self._part_lp(self._local_plans[n],
                                        self._node_dist(n, env), env[n])
            else:
                lp = lp + self._site_lp(n, self._node_dist(n, env),
                                        self._term_value(n, env))
        return lp

    def _counts(self, name: str) -> bool:
        """Whether this rank counts term ``name`` (or the Jacobian of site
        ``name``): a named one cut over a set S of the data axes on the
        ranks at index 0 of every data axis outside S, each block once; any
        other on data rank 0."""
        layout = self._data_dims.get(name)
        if layout is None or name not in self._local_plans:
            return self.comm.data_rank == 0
        return self._geo.leads(layout)

    def logpdf(self, state: dict, terms: tuple[str, ...] | None = None) -> torch.Tensor:
        """Sum of stochastic log-densities (constrained space, no Jacobian)
        of ONE chain's state, summed over the data group.  ``terms``
        restricts to a subset (reference block logpdf, simulation.jl:54-58).
        On a data axis of more than one rank it is a collective: call it
        outside ``vmap`` (there, ``logpdf_part``, given the state that
        ``with_wholes`` completes where the model gathers nodes)."""
        if self._gather_dims:
            state = {k: v[0] for k, v in self.with_wholes(
                {k: v[None] for k, v in state.items()}).items()}
        return self.comm.data_sum(self.logpdf_part(state, terms))[0]

    def eval_logicals(self, state: dict) -> dict:
        """State extended with logical node values (for monitoring), as
        this rank holds them: a node it holds in part (``local_dims``), its
        slice; any other whole."""
        env = self._eval_env(state)
        return {**{n: state[n] for n in self.stochastic},
                **{n: env[n] for n in self.logical}}

    # ---- this data rank's slices ----------------------------------------
    @property
    def local_state(self) -> frozenset:
        """Stochastic sites the state holds in part: the data sites
        (observed, or imputed by MISS) named on the data axis, and the named
        sampled sites held as slices (``_held``)."""
        return frozenset(n for n in self.local_dims if n in self.sites)

    def cut_state(self, state: dict, lead: int = 1) -> dict:
        """A whole state (chain-stacked: ``lead`` 1) as this data rank
        holds it: every site it holds in part (``local_state``) cut to its
        slice."""
        return {n: self.local(n, v, lead) for n, v in state.items()}

    def local_shape(self, name: str) -> tuple[int, ...]:
        """The shape of a stochastic site or logical node as this data rank
        holds it (its whole shape unless it holds it in part)."""
        shape = (self.sites[name].shape if name in self.sites
                 else self.logical_shapes[name])
        layout = self.local_dims.get(name)
        if layout is None:
            return tuple(shape)
        return self._geo.shape_of(shape, layout)

    def local(self, name: str, x, lead: int = 0):
        """This data rank's slice of a whole value ``x`` (array or tensor,
        ``lead`` dims before the node's own) of a node it holds in part
        (``local_dims``); ``x`` itself for any other node."""
        layout = self.local_dims.get(name)
        return x if layout is None else self._block(x, layout, lead)

    def _block(self, x, layout, lead: int = 0):
        """This rank's block of ``x`` under ``layout``."""
        return self._geo.block(x, layout, lead=lead)

    def whole(self, name: str, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """The whole value of node ``name`` from this rank's ``x`` (``lead``
        dims before the node's own): a node it holds in part is gathered
        over the data group (a collective).  A node that is neither whole
        nor a slice (``mixed``) raises: ``WholeValues`` computes it again
        from its parents' whole values."""
        if name in self.mixed:
            raise ValueError(
                f"node {name!r} is computed from a data rank's slices and is "
                f"neither whole nor a slice of the whole: read it through "
                f"WholeValues, which computes it from whole values")
        layout = self.local_dims.get(name)
        return x if layout is None else self.comm.gather_data(x, layout, lead)

    def _env_value(self, name: str, value):
        """A state value as the density's env holds it: a named sampled
        site whole in the state cut to this rank's slice (a site held in
        part is its slice already)."""
        layout = self._env_dims.get(name)
        return value if layout is None else self._block(value, layout)

    # ---- block machinery ----------------------------------------------
    def block_terms(self, params: tuple[str, ...]) -> tuple[str, ...]:
        """Stochastic log-density terms affected by ``params``: the params
        themselves plus their stochastic targets (reference model.jl:185-205,
        gettargets pruning graph.jl:93-103)."""
        terms = list(params)
        for t in self.model.keys("target", list(params)):
            if isinstance(self.model.nodes.get(t), StochasticNode) and t not in terms:
                terms.append(t)
        order = {n: i for i, n in enumerate(self.model.topo)}
        return tuple(sorted(terms, key=order.__getitem__))

    def block_ravel_spec(self, params: tuple[str, ...], transform: bool) -> RavelSpec:
        """The block's flat vector on this rank: a site held in part
        (``_held``) at its slice's shape."""
        shapes = {}
        for p in params:
            shape = (self.sites[p].unconstrained_shape if transform
                     else self.sites[p].shape)
            if p in self._held:
                shape = self._geo.shape_of(shape, self._held[p])
            shapes[p] = shape
        example = {p: np.zeros(s) for p, s in shapes.items()}
        return make_ravel_spec(example, dtype=self.dtype)

    def block_functions(self, params: tuple[str, ...], transform: bool,
                        prior_only: bool = False):
        """Returns (pack, unpack, spec, logf), each on ONE chain's values:

        - ``pack(state) -> flat``          (reference unlist, simulation.jl:110-134)
        - ``unpack(flat, state) -> {p: value}``  (reference relist)
        - ``logf(flat, state) -> scalar``  (reference logpdf!, simulation.jl:77-90)

        With ``transform=True`` the flat vector is unconstrained and ``logf``
        includes the log-Jacobian of the block's own sites.  A site this
        data rank holds in part (``_held``) is its slice in the flat vector,
        with its slice's Jacobian; one whose prior reads slices
        (``_part_sites``) is packed and unpacked as the rank's slice:
        chain-stacked, ``block_maps`` joins it.  With
        ``prior_only=True`` ``logf`` sums the params' own densities (and
        Jacobians) only, not their targets': the ABC sampler's log prior
        (reference abc.jl:46, 105-107).
        """
        key = (tuple(params), bool(transform), bool(prior_only))
        if key in self._block_cache:
            return self._block_cache[key]
        params = tuple(params)
        terms = params if prior_only else self.block_terms(params)
        spec = self.block_ravel_spec(params, transform)
        pset = set(params)
        # split over the data axes: this rank sums its part of every named
        # term it counts (``_counts``), and data rank 0 alone every other
        # term and the Jacobian of the whole sites
        split = self.block_split(params, prior_only)
        lead = not split or self.comm.data_rank == 0

        def pack(state):
            return spec.ravel(self._flat_parts(params, transform, state))

        def _decode(flat, state, only=None):
            """Walk topo order decoding block sites (whose bijectors may
            depend on parents) and recomputing intermediate logicals.  The
            block's sites are decoded whole (``values``, and the Jacobian);
            the env holds them as the density reads them.  ``only``: the
            logicals to compute (no term's distribution)."""
            parts = spec.unravel(flat)
            env = {**self.inputs, **self._fixed_wholes}
            env.update({n: self._env_value(n, v) for n, v in state.items()
                        if n not in pset})
            env.update({_wkey(n): state[n] for n in self._state_wholes
                        if n in state and n not in pset})
            wenv = self._whole_env(state, skip=pset)
            logdet = torch.zeros((), dtype=self.dtype, device=self.device)
            part_logdet = torch.zeros_like(logdet)
            dists, values = {}, {}
            for name in self.model.topo:
                node = self.model.nodes[name]
                if isinstance(node, LogicalNode):
                    if only is None or name in only:
                        env[name] = self._logical(name, node, env, wenv)
                elif name in pset:
                    dist = self._node_dist(name, env)
                    dists[name] = dist
                    cut = self._part_sites.get(name) if transform else None
                    if transform and (cut is not None or name in self._held):
                        # held in part, or its prior (and so its bijector)
                        # reads slices: the rank maps its slice, with its
                        # slice's Jacobian where it counts the site
                        b = self._slice_bijector(name, dist)
                        u = (parts[name] if cut is None
                             else self._block(parts[name], cut))
                        values[name] = env[name] = b.forward(u)
                        if self._geo.leads(self._held.get(name, cut)):
                            part_logdet = part_logdet + torch.sum(
                                b.event_log_det(u, max(dist.event_ndim, 0)))
                        continue
                    if transform:
                        b = dist.bijector()
                        u = parts[name]
                        values[name] = b.forward(u)
                        logdet = logdet + torch.sum(
                            b.event_log_det(u, max(dist.event_ndim, 0)))
                    else:
                        values[name] = parts[name]
                    env[name] = self._env_value(name, values[name])
                    if wenv is not None and name in self._env_dims:
                        wenv[name] = values[name]
                    if name in self._state_wholes:
                        env[_wkey(name)] = values[name]
                elif name in terms and only is None:
                    dists[name] = self._node_dist(name, env)
            return env, dists, logdet, part_logdet, values

        # unpack computes what the block's sites' laws read, no term
        bijected = _reads(self.model, params)

        def unpack(flat, state):
            return _decode(flat, state, bijected)[4]

        def logf(flat, state):
            env, dists, logdet, part_logdet, _ = _decode(flat, state)
            lp = part_logdet
            for n in terms:
                # a block site is in its support by construction in
                # unconstrained space: no masking (keeps autodiff clean)
                support = not (transform and n in pset)
                if n in self._local_plans and self._counts(n):
                    lp = lp + self._part_lp(self._local_plans[n], dists[n],
                                            env[n], support)
            if lead:
                # the terms counted on data rank 0 alone, and the Jacobian
                # of the whole sites
                rest = logdet
                for n in terms:
                    if n not in self._local_plans:
                        rest = rest + self._site_lp(
                            n, dists[n], self._term_value(n, env),
                            not (transform and n in pset))
                lp = lp + rest
            if not transform:
                # Reference early -Inf exit (simulation.jl:77-90): when block
                # params leave their support, downstream terms may evaluate to
                # NaN (e.g. sqrt of a negative variance); the whole block
                # density is -inf, not NaN, so rejection loops terminate.
                lp = torch.where(torch.isnan(lp), -torch.inf, lp)
            return lp

        out = (pack, unpack, spec, logf)
        self._block_cache[key] = out
        self._block_cache[("decode",) + key] = _decode
        return out

    def block_density(self, params: tuple[str, ...], transform: bool,
                      prior_only: bool = False, grad: bool = False):
        """``density(x, state)``: the block's ``logf`` on chain-stacked
        flat vectors ``x (C, dim)`` (or candidates folded into the chain
        axis) and states, vmapped and completed over the data group
        (``block_sum``): ``(value, grad)`` with ``grad``, else the value.
        Called outside ``vmap``.

        A block that moves the leaves of a gathered node it reads
        (``block_gathers``: ``"call"``) gathers them once per call, in four
        steps: the rank's slices of the leaves from ``x`` (vmapped); one
        all-gather of them, outside ``vmap``, the padded tails dropped; the
        density and its gradient in ``x`` and in the gathered leaves; and
        each rank's own slice of the leaves' cotangent pulled back through
        the first step (a vjp), on the ranks that count the slice.  Each
        rank's cotangent is its own terms': the named terms' parts (the
        sum-to-zero effect b = sqrt(s2) * (z - mean(z)) that each rank's y
        reads its groups of) and, on data rank 0, the rest, so one
        all-reduce over the data group sums them first: the transpose of
        the all-gather.  The whole coordinates' shares join
        ``block_sum``'s all-reduce."""
        _, _, _, logf = self.block_functions(params, transform, prior_only)
        total = self.block_sum(params, prior_only)
        if self.block_gathers(params, prior_only) != "call":
            if not grad:
                vlogf = torch.func.vmap(logf)
                return lambda x, state: total(vlogf(x, state))[0]
            gv = torch.func.vmap(torch.func.grad_and_value(logf))

            def density(x, state):
                g, v = gv(x, state)
                return total(v, g)
            return density
        parents = torch.func.vmap(self.block_parents(params, transform,
                                                     prior_only))

        def wlogf(x, state, wholes):
            return logf(x, {**state, **wholes})
        if not grad:
            vlogf = torch.func.vmap(wlogf)
            return lambda x, state: total(vlogf(
                x, state, self._gathered_from(parents(x, state))))[0]
        gv = torch.func.vmap(torch.func.grad_and_value(wlogf, argnums=(0, 2)))
        pull = torch.func.vmap(self.block_pull(params, transform, prior_only))

        def density(x, state):
            wholes = self._gathered_from(parents(x, state))
            (gx, gw), v = gv(x, state, wholes)
            gw = dict(zip(gw, self.comm.data_sum(*gw.values())))
            return total(v, gx + pull(x, state, gw))
        return density

    def block_parents(self, params: tuple[str, ...], transform: bool,
                      prior_only: bool = False):
        """``parents(flat, state) -> {name: value}``: this rank's slices of
        the gathered leaves (``_gather_dims``) at ONE chain's flat vector,
        as the block's density computes them."""
        self.block_functions(params, transform, prior_only)
        decode = self._block_cache[("decode", tuple(params), bool(transform),
                                    bool(prior_only))]
        only = _reads(self.model, [n for n in (*self._gather_dims, *params)
                                   if n in self.model.nodes])
        only.update(self._gather_dims)

        def parents(flat, state):
            env = decode(flat, state, only)[0]
            return {p: env[p] for p in self._gather_dims}
        return parents

    def block_pull(self, params: tuple[str, ...], transform: bool,
                   prior_only: bool = False):
        """``pull(flat, state, gw) -> (dim,)``: ONE chain's gradient in the
        gathered leaves' whole values ``gw`` (keyed by ``_wkey``), this
        rank's slice of it (zero in the padded tail) pulled back to its
        flat vector through ``block_parents``.  A slice held alike by the
        ranks that differ on the data axes it is not cut over counts on
        one of them (``DataGroup.leads``), so each block's share is pulled
        back once over the data group."""
        parents = self.block_parents(params, transform, prior_only)
        geo = self._geo

        def pull(flat, state, gw):
            ct = {}
            for p, d in self._gather_dims.items():
                s = self._rank_slice(gw[_wkey(p)], p, d)
                ct[p] = s if geo.leads(d) else torch.zeros_like(s)
            _, vjp = torch.func.vjp(lambda x: parents(x, state), flat)
            return vjp(ct)[0]
        return pull

    def _rank_slice(self, x, name: str, layout, lead: int = 0):
        """This rank's block of node ``name``'s whole value without its
        padded tails: ``x`` zero-padded back to its padded length along
        each dim of its record (``_padded``), then cut by ``layout``."""
        for dim, (given, length) in self._padded.get(name, {}).items():
            ax = lead + dim
            if x.shape[ax] == given:
                more = list(x.shape)
                more[ax] = length - given
                x = torch.cat([x, x.new_zeros(more)], dim=ax)
        return self._block(x, layout, lead)

    def block_prepare(self, params: tuple[str, ...], prior_only: bool = False):
        """``prepare(state) -> state``: the chain-stacked state a block step
        hands its density, pack and unpack.  For a block that reads a
        gathered node it carries the whole values of the node's parents
        (``with_wholes``, a collective, outside any CUDA graph): once per
        step, and in a block that gathers per call too where its sites'
        priors read such a node (their bijectors).  The identity
        otherwise."""
        mode = self.block_gathers(params, prior_only)
        if mode == "call" and not self._gather_reads(tuple(params)):
            mode = ""
        return self.with_wholes if mode else _same

    def with_wholes(self, state: dict) -> dict:
        """A chain-stacked ``state`` with the whole values of the gathered
        nodes' parents (``_gather_dims``), each under ``_wkey``: the rank's
        slices, computed under ``vmap``, gathered over the data group (one
        all-gather for all) with their padded tails dropped.  ``state``
        itself without gathered nodes.  A collective, outside ``vmap``."""
        if not self._gather_dims:
            return state
        return {**state, **self._gathered_from(
            torch.func.vmap(self._parent_values)(state))}

    def _parent_values(self, state: dict) -> dict:
        env = self._eval_env(state)
        return {p: env[p] for p in self._gather_dims}

    def _gathered_from(self, slices: dict) -> dict:
        """The whole values of the gathered parents from this rank's
        chain-stacked ``slices`` (one all-gather over the data group)."""
        names = list(self._gather_dims)
        every = self.comm.gather_data_many([slices[p] for p in names])
        return self.join_wholes([dict(zip(names, ts)) for ts in every])

    def join_wholes(self, per_rank: list) -> dict:
        """Every data rank's chain-stacked slices of the gathered parents,
        in data-rank order, joined into their whole values without the
        padded tails, keyed by ``_wkey``: each from the ranks that count
        it (``DataGroup.leads``), which hold its blocks once each."""
        geo, out = self._geo, {}
        for p, layout in self._gather_dims.items():
            parts = torch.stack([r[p] for k, r in enumerate(per_rank)
                                 if geo.leads(layout, k)])
            out[_wkey(p)] = self._trim(geo.assemble(parts, layout, lead=1),
                                       p, lead=1)
        return out

    def _flat_parts(self, params, transform: bool, state: dict) -> dict:
        """The block's values as its flat vector holds them, per site, from
        ONE chain's state: unconstrained under ``transform``.  A site held
        in part (``_held``), or whose prior reads slices (``_part_sites``),
        maps this rank's slice."""
        if not transform:
            return {p: state[p] for p in params}
        env = self._eval_env(state)
        out = {}
        for p in params:
            dist = self._node_dist(p, env)
            dim = self._part_sites.get(p)
            if dim is None and p not in self._held:
                out[p] = dist.bijector().inverse(state[p])
                continue
            out[p] = self._slice_bijector(p, dist).inverse(
                state[p] if dim is None else self._block(state[p], dim))
        return out

    def block_maps(self, params: tuple[str, ...], transform: bool,
                   prior_only: bool = False):
        """``(vpack, vunpack)``: ``block_functions``' pack and unpack on
        chain-stacked states.  Under ``transform`` a site whose prior reads
        slices (``_part_sites``) is mapped on each data rank's slice and
        joined over the data group (a collective, outside ``vmap``), so
        every rank holds the whole flat vector and the whole values."""
        pack, unpack, spec, _ = self.block_functions(params, transform,
                                                     prior_only)
        joined = ({p: self._part_sites[p] for p in params
                   if p in self._part_sites} if transform else {})
        vunpack = torch.func.vmap(unpack)
        if not joined:
            return torch.func.vmap(pack), vunpack

        def join(values):
            return {p: self.comm.gather_data(v, joined[p], 1) if p in joined
                    else v for p, v in values.items()}

        vparts = torch.func.vmap(
            lambda st: self._flat_parts(tuple(params), True, st))
        vravel = torch.func.vmap(spec.ravel)
        return (lambda state: vravel(join(vparts(state))),
                lambda x, state: join(vunpack(x, state)))

    # ---- forward (generative) sampling --------------------------------
    def forward_sample(self, key, state: dict, names=None) -> dict:
        """Draw the given stochastic nodes of a chain-stacked ``state`` from
        their conditional priors in topo order (ancestral sampling), every
        chain at once, chain ``c`` from its key ``key[c]`` (``(C, 2)``):
        each drawn node takes ``key, sub = split(key)`` and draws from
        ``sub``, as the JAX package's ``forward_sample`` does per chain.
        Powers prior init and MISS imputation (reference miss.jl:54-59) and
        posterior-predictive draws (modelstats.jl:71-102).

        Each node's parameters are computed under ``vmap``, and the draw is
        made once, chain-stacked, outside.  A site this data rank holds in
        part is drawn at its whole shape, from the distribution's
        parameters gathered over the data group, so that the numbers are
        the unsharded run's; the rank keeps its slice.  A site whose
        distribution reads a gathered node reads it whole
        (``with_wholes``)."""
        names = set(self.stochastic if names is None else names)
        out = dict(state)
        chains = next(iter(state.values())).shape[0]
        for name in self.model.topo:
            if name not in names:
                continue
            if self._gather_reads([name]):
                dist = self.stacked_node_dist(name, self.with_wholes(out))
            else:
                dist = self.stacked_node_dist(name, out)
            part = name in self.local_dims
            if (part or name in self._leaf_dims) and name not in self._whole_terms:
                dist = self._whole_stacked(name, dist)
            target = tuple(self.sites[name].shape)
            stacked = bool(dist_flatten(dist)[0])
            per_chain = tuple(dist.batch_shape + dist.event_shape)[int(stacked):]
            # distribution batch smaller than the node (parameter recycling,
            # e.g. iid Normal(0, s) over an array node): the missing lead
            # dims are drawn iid, never one draw copied.  A distribution of
            # constants has no chain axis either, and gets one the same way.
            lead = target[: len(target) - len(per_chain)]
            key, sub = R.split(key)
            if stacked:
                with keys_lead("params"):
                    val = dist.sample(sub, lead).movedim(len(lead), 0)
            else:
                with keys_lead("draw"):
                    val = dist.sample(sub, (chains,) + lead)
            if name in self._padded and name in self._whole_terms:
                # drawn whole without its padded tail: padded back
                val = _pad_tail(val, self._padded[name], lead=1)
            if tuple(val.shape[1:]) != target:      # trailing recycling
                val = val.expand((chains,) + target)
            if part:
                val = self.local(name, val, lead=1).clone(
                    memory_format=torch.contiguous_format)
            out[name] = val.to(dtype=self.dtype, device=self.device)
        return out

    def _whole_stacked(self, name: str, dist):
        """The chain-stacked distribution of a site this rank holds in part
        (or a named sampled site whose prior reads slices), at the site's
        whole shape: parameters that are slices are gathered over the data
        group (a distribution with whole parameters is already whole)."""
        dims = self._leaf_dims.get(name)
        if dims is None:
            return dist
        leaves, rebuild = dist_flatten(dist)
        out = []
        for t, (layout, ndim) in zip(leaves, dims):
            if layout == -1:
                raise ValueError(
                    f"site {name!r} cannot be drawn whole on a data rank: a "
                    f"parameter of its distribution is neither whole nor a "
                    f"slice of the whole")
            out.append(t if layout is None
                       else self.comm.gather_data(t, layout, t.dim() - ndim))
        return rebuild(out)

    # ---- monitoring ----------------------------------------------------
    def _monitor_selections(self):
        """``(name, shape, indices-or-None, local shape or None, width)``
        per monitored node, sorted by name: ``local`` is given for a node
        this data rank holds in part (packed as its whole slice, its rows
        gathered at fetch); ``width`` is its columns in a packed row."""
        out = []
        for n in sorted(self.model.keys("monitor")):
            shape = (self.sites[n].shape if n in self.sites
                     else self.logical_shapes[n])
            size = int(np.prod(shape)) if shape else 1
            idx = self.model.nodes[n].monitor_indices(size)
            local = self.local_shape(n) if n in self.local_dims else None
            width = (int(np.prod(local)) if local is not None
                     else size if idx is None else len(idx))
            out.append((n, shape, None if idx is None else torch.as_tensor(
                idx, device=self.device), local, width))
        return out

    def monitor_spec(self):
        """(names, flat element labels, pack fn) for monitored nodes.
        Labels follow the reference's ``beta[1]`` convention
        (src/variate.jl:76-88); nodes may monitor a subset of elements via
        1-based column-major index vectors (reference setmonitor!,
        dependent.jl:31-48).  The pack fn takes one chain's state; a node
        this data rank holds in part is packed as its whole slice, and
        ``gather_monitored`` turns kept rows into the labels' rows."""
        selections = self._monitor_selections()
        labels = []
        for n, shape, idx, _, _ in selections:
            names_n = elementwise_names(n, shape)
            labels.extend(names_n if idx is None else [names_n[i] for i in idx])

        def pack_monitored(state):
            vals = self.eval_logicals(state)
            # Julia column-major flatten for >1-d arrays
            flat = []
            for n, _, idx, local, width in selections:
                if n in self.mixed:     # filled whole by ``monitor_rows``
                    flat.append(torch.zeros((width,), dtype=self.dtype,
                                            device=self.device))
                    continue
                v = _column_major(vals[n]).to(self.dtype)
                if idx is not None and local is None:
                    v = v[idx]
                flat.append(v)
            return (torch.cat(flat) if flat
                    else torch.zeros((0,), dtype=self.dtype, device=self.device))

        return tuple(s[0] for s in selections), labels, pack_monitored

    def monitor_rows(self):
        """``rows(state) -> (C, width)``: ``pack_monitored`` of every chain
        of a chain-stacked state.  A monitored node that is neither whole
        nor a slice on a data rank (``mixed``) is computed again whole from
        its parents' whole values outside ``vmap`` (``WholeValues``, a
        collective), in the unsharded run's columns.  Where the model
        gathers nodes, the state carries their parents' whole values first
        (``with_wholes``)."""
        selections = self._monitor_selections()
        _, _, pack = self.monitor_spec()
        vpack = torch.func.vmap(pack)
        if not any(s[0] in self.mixed for s in selections):
            if self._gather_dims:
                return lambda state: vpack(self.with_wholes(state))
            return vpack

        def rows(state):
            state = self.with_wholes(state)
            out = vpack(state)
            values = WholeValues(self, self.inputs,
                                 torch.func.vmap(self.eval_logicals)(state))
            at = 0
            for n, _, idx, _, width in selections:
                if n in self.mixed:
                    v = torch.func.vmap(_column_major)(values[n]).to(self.dtype)
                    out[:, at:at + width] = v if idx is None else v[:, idx]
                at += width
            return out
        return rows

    def monitor_width(self) -> int:
        """The length of a ``pack_monitored`` row on this rank."""
        return sum(s[-1] for s in self._monitor_selections())

    def gather_monitored(self, rows: torch.Tensor) -> torch.Tensor:
        """Kept rows ``(draws, width, chains)`` of ``pack_monitored`` as the
        labels' rows: the rows of the nodes this data rank holds in part
        are gathered over the data group (one all-gather for all) and put
        in the unsharded run's label order.  The identity when there are
        none."""
        selections = self._monitor_selections()
        if all(local is None for _, _, _, local, _ in selections):
            return rows
        every = self.comm.gather_data(rows[None], 0)   # (ranks, draws, width, C)
        geo, out, at = self._geo, [], 0
        for n, _, idx, local, width in selections:
            seg = every[:, :, at:at + width]
            at += width
            if local is None:
                out.append(seg[0])
                continue
            # the columns of a slice are the C order of its reversed shape:
            # its blocks, from the ranks that count them, joined there
            layout = self.local_dims[n]
            rev = tuple(reversed(local))
            parts = torch.stack([
                s.reshape((s.shape[0],) + rev + (s.shape[-1],))
                for k, s in enumerate(seg) if geo.leads(layout, k)])
            v = geo.assemble(parts, {len(local) - 1 - d: axes
                                     for d, axes in layout.items()}, lead=1)
            v = v.reshape(v.shape[0], -1, v.shape[-1])
            out.append(v if idx is None else v[:, idx])
        return torch.cat(out, dim=1)


def _column_major(v: torch.Tensor) -> torch.Tensor:
    """Julia's ``vec``: the column-major flatten of ``v``."""
    return torch.reshape(v.permute(*reversed(range(v.dim()))) if v.dim() > 1
                         else v, (-1,))


def _shake(x: torch.Tensor, record: dict) -> torch.Tensor:
    """``x`` with the padded tail of each dim of ``record`` (``{dim: (given,
    padded length)}``) moved by distinct amounts."""
    x = x.clone()
    for dim, (given, length) in record.items():
        at = (slice(None),) * dim + (slice(given, length),)
        step = torch.arange(1, 1 + length - given, dtype=x.dtype,
                            device=x.device)
        x[at] = x[at] + step.reshape((-1,) + (1,) * (x.dim() - dim - 1))
    return x


def _moved_outside(value, moved, record: dict) -> bool:
    """Whether an entry of ``moved`` differs from ``value`` (NaN equal to
    NaN) outside the padded tail of each dim of ``record`` (``{dim:
    (given, padded length)}``)."""
    if moved.shape != value.shape:
        return True
    changed = ~((moved == value) | (torch.isnan(moved) & torch.isnan(value)))
    for dim, (given, length) in record.items():
        changed.narrow(dim, given, length - given).fill_(False)
    return bool(changed.any())


def _pad_tail(t: torch.Tensor, record: dict, lead: int = 0) -> torch.Tensor:
    """``t``, a value without its padded tails, edge-padded along each dim
    of ``record`` (``{dim: (given, padded length)}``; ``lead`` dims before
    the value's own) to its padded length, as a padded array holds its
    tail."""
    for dim, (given, length) in record.items():
        ax = lead + dim
        if t.shape[ax] != given:
            continue
        tail = t.narrow(ax, given - 1, 1)
        more = list(t.shape)
        more[ax] = length - given
        t = torch.cat([t, tail.expand(more)], dim=ax)
    return t


def _fits(shape: tuple, within: tuple) -> bool:
    """``shape`` broadcasts to ``within`` without growing it."""
    return len(shape) <= len(within) and all(
        a in (1, b) for a, b in zip(reversed(shape), reversed(within)))


def _close(a, b, tol: float) -> bool:
    """``a`` equals ``b`` to ``tol`` of ``b``'s scale (NaN equal to NaN)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        return False
    if not b.is_floating_point():
        return bool(torch.equal(a, b))
    a, b = a.double(), b.double()
    finite = b[torch.isfinite(b)]
    scale = max(float(finite.abs().max()) if finite.numel() else 0.0, 1.0)
    return bool(torch.allclose(a, b, rtol=tol, atol=tol * scale,
                               equal_nan=True))


def _classify(whole, parts, tol: float, geo: DataGroup):
    """How the data ranks' values ``parts`` of a node relate to its whole
    value: None if every part is the whole, the layout (``{dim: axes}``)
    under which each is the rank's block of it, else ``"mixed"``."""
    whole = torch.as_tensor(whole)
    parts = [torch.as_tensor(p) for p in parts]
    if all(p.shape == whole.shape for p in parts):
        return None if all(_close(p, whole, tol) for p in parts) else "mixed"
    shape = parts[0].shape
    if any(p.shape != shape for p in parts):
        return "mixed"
    for layout in geo.layouts(whole.shape, shape):
        if all(_close(p, geo.block(whole, layout, k), tol)
               for k, p in enumerate(parts)):
            return layout
    return "mixed"


def _cut_layout(whole, parts, geo: DataGroup):
    """How a resolved node's whole value is cut for the data ranks whose
    own computation gave ``parts``: None (whole) if they have its shape,
    else the layout under which their shapes are its blocks and the ranks
    that would hold the same block computed the same part, else False."""
    whole = torch.as_tensor(whole)
    parts = [torch.as_tensor(p) for p in parts]
    shapes = {tuple(p.shape) for p in parts}
    if shapes == {tuple(whole.shape)}:
        return None
    if len(shapes) != 1:
        return False
    for layout in geo.layouts(whole.shape, next(iter(shapes))):
        seen = {}
        for k, p in enumerate(parts):
            at = tuple(geo.blocks(layout, k).items())
            if at in seen and not torch.equal(seen[at], p):
                break
            seen.setdefault(at, p)
        else:
            return layout
    return False


def _reads(model, names) -> set:
    """Every node that the logicals ``names`` read, directly or through
    another logical."""
    out, todo = set(), list(names)
    while todo:
        for d in model.nodes[todo.pop()].deps:
            if d not in out:
                out.add(d)
                if isinstance(model.nodes.get(d), LogicalNode):
                    todo.append(d)
    return out


def _leaf_dims(whole, parts, tol: float, geo: DataGroup) -> list:
    """Per parameter of a distribution (``dist_flatten``'s leaves): the
    layout under which the slices' parameters ``parts`` are blocks of the
    whole one (None: whole; -1: neither), and its ndim."""
    leaves = dist_flatten(whole)[0]
    split = [dist_flatten(p)[0] for p in parts]
    out = []
    for i, w in enumerate(leaves):
        how = _classify(w, [s[i] for s in split], tol, geo)
        out.append((-1 if how == "mixed" else how, w.dim()))
    return out


def _lp_close(parts, whole, tol: float) -> bool:
    """The sum of the log densities ``parts`` equals ``whole`` to ``tol``
    of their scale, every one of them finite."""
    vals = [float(p) for p in parts]
    total, want = sum(vals), float(whole)
    if not np.isfinite(vals + [want]).all():
        return False
    scale = max(sum(abs(v) for v in vals) + abs(want), 1.0)
    return abs(total - want) <= tol * scale


def _identity(*tensors):
    return tensors


def _same(state):
    return state


def compile_model(model: Model, inputs: dict, inits: dict, *, device,
                  dtype=None, masks: dict | None = None,
                  comm: MeshComm | None = None,
                  site_specs: dict | None = None,
                  pads: dict | None = None) -> CompiledModel:
    """Compile ``model`` for ``device`` (required: nothing defaults to the
    CPU).  ``dtype`` defaults to float64 on the CPU and float32 elsewhere.
    ``comm`` and ``site_specs`` place it on a rank of a mesh, and ``pads``
    gives the lengths as given of the dims its data axis padded (``mcmc``
    passes them)."""
    return CompiledModel(model, inputs, inits, device=device, dtype=dtype,
                         masks=masks, comm=comm, site_specs=site_specs,
                         pads=pads)
