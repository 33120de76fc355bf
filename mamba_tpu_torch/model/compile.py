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

Under a mesh with a data axis (``comm.data_size > 1``) every array stays
whole on every rank, and each data rank's block densities sum only its
slice of the observed sites named in ``site_specs`` (the pad mask and its
own slice), plus, on data rank 0 alone, every other term: the parts sum to
the density over the data group (``block_sum``).  ``logpdf`` stays the
whole density on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops.distributions.base import dist_flatten
from ..parallel.mesh import MeshComm, _spec_names
from ..utils.convert import to_tensor
from ..utils.pytree import RavelSpec, elementwise_names, make_ravel_spec
from .model import Model
from .nodes import LogicalNode, StochasticNode


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
                 comm: MeshComm | None = None, site_specs: dict | None = None):
        self.model = model
        self.device = torch.device(device)
        self.dtype = dtype or default_dtype(self.device)
        #: this rank's collectives over the run's mesh (none: the identity)
        self.comm = comm or MeshComm()
        #: per-site likelihood masks (True = real observation); masked-out
        #: entries contribute exactly 0 to every log density
        self.masks = {k: np.asarray(v, dtype=bool)
                      for k, v in (masks or {}).items()}
        missing = model.input_names - set(inputs)
        if missing:
            raise ValueError(f"missing input values for {sorted(missing)}")
        self.inputs = {k: self.tensor(v) for k, v in inputs.items()
                       if k in model.input_names}

        self.stochastic = model.keys("stochastic")
        self.logical = model.keys("logical")

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
        #: how ``_site_lp`` applies each mask (``_mask_plan``): the whole
        #: density's, and this data rank's part of a split site
        self._plans = {n: self._mask_plan(n, m) for n, m in self.masks.items()}
        self._local_plans = {n: self._mask_plan(n, m) for n, m in
                             self._local_masks(site_specs or {}).items()}

    def tensor(self, v) -> torch.Tensor:
        """A value as a tensor on this model's device: floating values in
        the model's dtype, others keep their kind."""
        return to_tensor(v, self.device, self.dtype)

    # ---- graph evaluation ---------------------------------------------
    def _call(self, node, env):
        with torch.device(self.device):
            return node.fn(*[env[d] for d in node.deps])

    def _eval_env(self, state: dict) -> dict:
        """All node values: inputs + stochastic state + logicals in topo
        order."""
        env = dict(self.inputs)
        env.update(state)
        for name in self.model.topo:
            node = self.model.nodes[name]
            if isinstance(node, LogicalNode):
                env[name] = self._call(node, env)
        return env

    def _node_dist(self, name: str, env: dict):
        return self._call(self.model.nodes[name], env)

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
    def _local_masks(self, site_specs: dict) -> dict[str, np.ndarray]:
        """This data rank's entries of each observed site that ``site_specs``
        shards over the data axis: its pad mask and its own slice of every
        sharded dim (the padded length divides by the data axis).  Sampled
        sites named there are replicated, a layout hint only."""
        comm = self.comm
        if comm.data_size == 1:
            return {}
        observed = set(self.model.keys("observed"))
        out = {}
        for name, spec in site_specs.items():
            if name not in observed:
                continue
            shape = self.sites[name].shape
            mask = self.masks.get(name, np.ones(shape, dtype=bool)).copy()
            split = False
            for dim, entry in enumerate(tuple(spec)):
                names = _spec_names(entry)
                if comm.chain_axis in names:
                    raise ValueError(f"site spec {spec} of {name!r} names the "
                                     f"chain axis {comm.chain_axis!r}")
                if comm.data_axis not in names:
                    continue
                per, rem = divmod(shape[dim], comm.data_size)
                if rem:
                    raise ValueError(f"dim {dim} of {name!r} ({shape[dim]}) "
                                     f"does not divide over the data axis")
                idx = [slice(None)] * len(shape)
                idx[dim] = np.r_[0:comm.data_rank * per,
                                 (comm.data_rank + 1) * per:shape[dim]]
                mask[tuple(idx)] = False
                split = True
            if split:
                out[name] = mask
        return out

    def _mask_plan(self, name: str, mask: np.ndarray):
        """How ``_site_lp`` applies ``mask`` to site ``name``:

        - ``("entries", m)``: ``m`` over the entries of ``log_prob``;
        - ``("events", m)``: the mask covers event dims and takes each event
          whole or not at all; ``m`` over the events;
        - ``("range", lo, hi, consts)``: it takes the events' entries
          lo..hi-1 along the dim that the distribution can split its event
          on (``event_split_dim``, e.g. the fused GLMM's groups), whole
          along the others; ``consts`` is the example distribution's
          ``split_constants(lo, hi)``, cut once here.

        Any other mask over event dims raises: summing part of an event is
        not that event's density, and an event is not dropped silently."""
        dist = self.example_dists[name]
        lp_ndim = len(self.sites[name].shape) - dist.event_ndim
        if mask.ndim <= lp_ndim:
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
                return ("range", lo, hi, dist.split_constants(lo, hi))
        raise ValueError(
            f"the mask of site {name!r} takes part of an event of its "
            f"{type(dist).__name__} (event dims {dist.event_ndim}); a mask "
            f"must take each event whole or not at all"
            + ("" if split is None else
               f", or a contiguous range along event dim {split}"))

    def block_split(self, params: tuple[str, ...], prior_only: bool = False) -> bool:
        """Whether the block's density is split over the data axis: its
        ``logf`` on this rank is a part, and the data group's parts sum to
        the density."""
        terms = tuple(params) if prior_only else self.block_terms(tuple(params))
        return any(n in self._local_plans for n in terms)

    def block_sum(self, params: tuple[str, ...], prior_only: bool = False):
        """``f(*tensors) -> tuple`` that completes the block's vmapped
        ``logf`` values and gradients on this rank: their sum over the data
        group (one all-reduce) for a split block, else the identity.  It is
        called on the outputs of ``torch.func.vmap``, never inside it."""
        if self.block_split(params, prior_only):
            return self.comm.data_sum
        return _identity

    # ---- full log density ---------------------------------------------
    def _site_lp(self, name: str, dist, value, *, support_mask=True,
                 local=False) -> torch.Tensor:
        """Total log density of one site, honoring an optional observation
        mask (masked entries contribute exactly 0, even if their values
        would be NaN/-inf); ``local`` takes this data rank's part of a
        split site."""
        plan = (self._local_plans if local else self._plans).get(name)
        if plan is None:
            if support_mask:
                return dist.total_log_prob(value)
            return torch.sum(dist.log_prob(value))
        if plan[0] == "range":
            return dist.log_prob_range(value, *plan[1:])
        mask = plan[1]
        lp = dist.log_prob(value)
        if support_mask:
            lp = torch.where(dist.in_support(value), lp, -torch.inf)
        return torch.sum(torch.where(mask, lp, torch.zeros_like(lp)))

    def logpdf(self, state: dict, terms: tuple[str, ...] | None = None) -> torch.Tensor:
        """Sum of stochastic log-densities (constrained space, no Jacobian).
        ``terms`` restricts to a subset (reference block logpdf,
        simulation.jl:54-58)."""
        env = self._eval_env(state)
        names = self.stochastic if terms is None else terms
        lp = torch.zeros((), dtype=self.dtype, device=self.device)
        for n in names:
            dist = self._node_dist(n, env)
            lp = lp + self._site_lp(n, dist, env[n])
        return lp

    def eval_logicals(self, state: dict) -> dict:
        """State extended with logical node values (for monitoring)."""
        env = self._eval_env(state)
        return {n: env[n] for n in list(self.stochastic) + list(self.logical)}

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
        shapes = {p: (self.sites[p].unconstrained_shape if transform
                      else self.sites[p].shape) for p in params}
        example = {p: np.zeros(s) for p, s in shapes.items()}
        return make_ravel_spec(example, dtype=self.dtype)

    def block_functions(self, params: tuple[str, ...], transform: bool,
                        prior_only: bool = False):
        """Returns (pack, unpack, spec, logf), each on ONE chain's values:

        - ``pack(state) -> flat``          (reference unlist, simulation.jl:110-134)
        - ``unpack(flat, state) -> {p: value}``  (reference relist)
        - ``logf(flat, state) -> scalar``  (reference logpdf!, simulation.jl:77-90)

        With ``transform=True`` the flat vector is unconstrained and ``logf``
        includes the log-Jacobian of the block's own sites.  With
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
        # split over the data axis: this rank sums its slice of the split
        # sites, and data rank 0 alone every other term and the Jacobian
        split = self.block_split(params, prior_only)
        lead = not split or self.comm.data_rank == 0

        def pack(state):
            if not transform:
                return spec.ravel({p: state[p] for p in params})
            env = self._eval_env(state)
            packed = {}
            for p in params:
                b = self._node_dist(p, env).bijector()
                packed[p] = b.inverse(env[p])
            return spec.ravel(packed)

        def _decode(flat, state):
            """Walk topo order decoding block sites (whose bijectors may
            depend on parents) and recomputing intermediate logicals."""
            parts = spec.unravel(flat)
            env = dict(self.inputs)
            env.update({n: v for n, v in state.items() if n not in pset})
            logdet = torch.zeros((), dtype=self.dtype, device=self.device)
            dists = {}
            for name in self.model.topo:
                node = self.model.nodes[name]
                if isinstance(node, LogicalNode):
                    env[name] = self._call(node, env)
                elif name in pset:
                    dist = self._call(node, env)
                    dists[name] = dist
                    if transform:
                        b = dist.bijector()
                        u = parts[name]
                        env[name] = b.forward(u)
                        logdet = logdet + torch.sum(
                            b.event_log_det(u, max(dist.event_ndim, 0)))
                    else:
                        env[name] = parts[name]
                elif name in terms:
                    dists[name] = self._call(node, env)
            return env, dists, logdet

        def unpack(flat, state):
            env, _, _ = _decode(flat, state)
            return {p: env[p] for p in params}

        def logf(flat, state):
            env, dists, logdet = _decode(flat, state)
            lp = logdet if lead else torch.zeros_like(logdet)
            for n in terms:
                dist = dists[n]
                if split and n in self._local_plans:
                    lp = lp + self._site_lp(n, dist, env[n], local=True)
                elif not lead:
                    continue
                elif transform and n in pset:
                    # in-support by construction; no masking (keeps autodiff clean)
                    lp = lp + self._site_lp(n, dist, env[n], support_mask=False)
                else:
                    lp = lp + self._site_lp(n, dist, env[n])
            if not transform:
                # Reference early -Inf exit (simulation.jl:77-90): when block
                # params leave their support, downstream terms may evaluate to
                # NaN (e.g. sqrt of a negative variance); the whole block
                # density is -inf, not NaN, so rejection loops terminate.
                lp = torch.where(torch.isnan(lp), -torch.inf, lp)
            return lp

        out = (pack, unpack, spec, logf)
        self._block_cache[key] = out
        return out

    # ---- forward (generative) sampling --------------------------------
    def forward_sample(self, gen, state: dict, names=None) -> dict:
        """Draw the given stochastic nodes of a chain-stacked ``state`` from
        their conditional priors in topo order (ancestral sampling), every
        chain at once.  Powers prior init and MISS imputation (reference
        miss.jl:54-59) and posterior-predictive draws (modelstats.jl:71-102).

        A generator cannot be drawn from under ``vmap``: each node's
        parameters are computed under it, and the draw is made once,
        chain-stacked, outside."""
        names = set(self.stochastic if names is None else names)
        out = dict(state)
        chains = next(iter(state.values())).shape[0]
        for name in self.model.topo:
            if name not in names:
                continue
            dist = self.stacked_node_dist(name, out)
            target = tuple(self.sites[name].shape)
            stacked = bool(dist_flatten(dist)[0])
            per_chain = tuple(dist.batch_shape + dist.event_shape)[int(stacked):]
            # distribution batch smaller than the node (parameter recycling,
            # e.g. iid Normal(0, s) over an array node): the missing lead
            # dims are drawn iid, never one draw copied.  A distribution of
            # constants has no chain axis either, and gets one the same way.
            lead = target[: len(target) - len(per_chain)]
            if stacked:
                val = dist.sample(gen, lead).movedim(len(lead), 0)
            else:
                val = dist.sample(gen, (chains,) + lead)
            if tuple(val.shape[1:]) != target:      # trailing recycling
                val = val.expand((chains,) + target)
            out[name] = val.to(dtype=self.dtype, device=self.device)
        return out

    # ---- monitoring ----------------------------------------------------
    def monitor_spec(self):
        """(names, flat element labels, pack fn) for monitored nodes.
        Labels follow the reference's ``beta[1]`` convention
        (src/variate.jl:76-88); nodes may monitor a subset of elements via
        1-based column-major index vectors (reference setmonitor!,
        dependent.jl:31-48).  The pack fn takes one chain's state."""
        monitored = sorted(self.model.keys("monitor"))
        labels = []
        selections = []      # (name, indices-or-None)
        for n in monitored:
            shape = (self.sites[n].shape if n in self.sites
                     else self.logical_shapes[n])
            size = int(np.prod(shape)) if shape else 1
            idx = self.model.nodes[n].monitor_indices(size)
            names_n = elementwise_names(n, shape)
            if idx is None:
                labels.extend(names_n)
            else:
                labels.extend(names_n[i] for i in idx)
            selections.append((n, None if idx is None else torch.as_tensor(
                idx, device=self.device)))

        def pack_monitored(state):
            vals = self.eval_logicals(state)
            # Julia column-major flatten for >1-d arrays
            flat = []
            for n, idx in selections:
                v = vals[n]
                v = torch.reshape(v.permute(*reversed(range(v.dim())))
                                  if v.dim() > 1 else v, (-1,))
                v = v.to(self.dtype)
                if idx is not None:
                    v = v[idx]
                flat.append(v)
            return (torch.cat(flat) if flat
                    else torch.zeros((0,), dtype=self.dtype, device=self.device))

        return tuple(monitored), labels, pack_monitored


def _identity(*tensors):
    return tensors


def compile_model(model: Model, inputs: dict, inits: dict, *, device,
                  dtype=None, masks: dict | None = None,
                  comm: MeshComm | None = None,
                  site_specs: dict | None = None) -> CompiledModel:
    """Compile ``model`` for ``device`` (required: nothing defaults to the
    CPU).  ``dtype`` defaults to float64 on the CPU and float32 elsewhere.
    ``comm`` and ``site_specs`` place it on a rank of a mesh (``mcmc``
    passes them)."""
    return CompiledModel(model, inputs, inits, device=device, dtype=dtype,
                         masks=masks, comm=comm, site_specs=site_specs)
