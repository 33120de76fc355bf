"""Local views on a mesh's data axis: each data rank holds and evaluates
only its slice of the inputs and sites that ``site_specs`` names, as GSPMD
does in the JAX package (mamba_tpu/model/mcmc.py:347-460,
mamba_tpu/parallel/mesh.py:42-80).

In one process, rank by rank (``_DataRank``: no collective is called):
the shapes each rank holds, its parts of every block density and gradient
and of ``logpdf``, summed over the ranks against the port's whole model
(rtol 1e-12) and the JAX package's compiled density at the same state
(rtol 1e-10), the padded cases held to the unsharded model on the
points as given; what the compiler refuses, naming the node; and
``forward_sample``'s slice of the unsharded draw.  Across two gloo ranks
(this file run as a script, started by ``parallel.launch.run_ranks``, as
tests/test_torch_multiproc.py does): whatever reads whole values, a Gibbs
block, modelstats (``logpdf_chains``, DIC, ``predict``), MISS, ABC and
the kept rows of a site a rank holds in part, against the run without a
mesh.  Float64 throughout.  The rank processes import no JAX: the tests
import it where they use it."""

import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mamba_tpu_torch as tmt
from mamba_tpu_torch.ops import random as R
from mamba_tpu_torch.model.mcmc import _chain_inits
from mamba_tpu_torch.model.nodes import StochasticNode
from mamba_tpu_torch.models import glmm as tglmm, line as tline, rats as trats
from mamba_tpu_torch.parallel.launch import run_ranks
from mamba_tpu_torch.parallel.mesh import (data_block, data_dim, make_mesh,
                                           pad_axes, pad_mask)
from mamba_tpu_torch.model.whole import WholeValues

torch.set_num_threads(2)

#: seconds a two-rank test may take, and a collective may wait
RANKS_TIMEOUT, GROUP_TIMEOUT = 150, 60


#: a layout (``{dim: axes}``) of one dim over the data axis
def _on(dim):
    return {dim: ("data",)}


class _DataRank:
    """Rank ``r`` of a (1, 2) chains x data mesh, for evaluating each part
    of a split density in one process (no collectives are called)."""
    chain_axis, data_axis, data_axes = "chains", "data", ("data",)
    chain_rank, chain_size, data_size = 0, 1, 2

    def __init__(self, r):
        self.data_rank = r

    @property
    def data_shape(self):
        return (self.data_size,)


def _jax():
    import jax
    import mamba_tpu as jmt
    return jax, jmt


def test_data_slice_cuts_equal_blocks_by_spec():
    """A rank's slice: ``data_block`` of the dim ``data_dim`` reads from
    the spec (a map of the dims cut to their axes)."""
    x = np.arange(2 * 6 * 4).reshape(2, 6, 4)
    (dim,) = data_dim((None, "data"), "data")
    assert data_dim((None, "data"), "data") == {1: ("data",)}
    parts = [data_block(x, dim, r, 3) for r in range(3)]
    assert all(p.shape == (2, 2, 4) for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts, 1), x)
    t = torch.as_tensor(x)
    (dim,) = data_dim(("data", None), "data")
    np.testing.assert_array_equal(          # a chain-stacked array: dim + 1
        data_block(t, 1 + dim, 1, 2), x[:, 3:])
    assert data_dim((None, None), "data") == {}
    assert data_dim(("model",), "data") == {}
    with pytest.raises(ValueError, match="does not divide"):
        data_block(x, *data_dim(("data",), "data"), 0, 3)
    with pytest.raises(ValueError, match="names the chain axis"):
        data_dim(("chains",), "data")
    with pytest.raises(ValueError, match="more than one dim"):
        data_dim(("data", "data"), "data")


def test_dgs_support_takes_the_distribution_s_device():
    from mamba_tpu_torch.samplers.dgs import dgs_support
    dist = tmt.Bernoulli(torch.full((3,), 0.5, dtype=torch.float32))
    tune = dgs_support(dist, (3,))
    assert tune.support.device == dist.p.device
    assert tune.support.tolist() == [[0.0, 1.0]] * 3


# ---- the cases: (model, inputs, init, masks) of each package ------------
LINE_SPECS = {"y": ("data",), "xmat": ("data", None)}
RATS_SPECS = {"y": ("data",), "alpha": ("data",), "beta": ("data",)}
GLMM_Y = {"y": (None, "data")}
GLMM_LOCAL = {"y": (None, "data"), "xt": (None, None, "data"), "z": ("data",)}
GLMM_GENERIC = {"y": ("data", None), "x": ("data", None, None), "z": ("data",)}
LINE6_SPECS = {"y": ("data",), "xmat": ("data", None)}
U_SPECS = {**LINE6_SPECS, "w": ("data",), "lo": ("data",), "u": ("data",)}
BIRATS_SPECS = {"Y": ("data", None), "beta": ("data", None)}
#: the GLMM with only its data named: z (and so b) stays whole
GLMM_DATA = {"y": (None, "data"), "xt": (None, None, "data")}
GLMM_GENERIC_DATA = {"y": ("data", None), "x": ("data", None, None)}
V_SPECS = {**LINE6_SPECS, "w": ("data",), "v": ("data", None)}
G, C = 40, 3


def _line(pkg):
    """line with y and xmat named: 5 observations padded to 6."""
    model, inputs, inits = pkg.models.line.build()
    axes = {"chains": 1, "data": 2}
    p_in, _ = pad_axes(axes, LINE_SPECS, inputs)
    p_init, pads = pad_axes(axes, LINE_SPECS, inits[0])
    return model, p_in, p_init, {"y": pad_mask(p_init["y"].shape, pads["y"])}


def _rats(pkg):
    model, inputs, inits = pkg.models.rats.build("nuts")
    return model, inputs, inits[0], None


def _xp(pkg):
    """The array module of a package's model lambdas."""
    if pkg is tmt:
        return torch
    import jax.numpy as jnp
    return jnp


def _six(pkg, extra=None, inits=None, samplers=(), y=(1.0, 3.0, 3.0, 3.0,
                                                      5.0, 6.0)):
    """line on six points (the data axis divides them, no padding), with
    ``extra(pkg)``'s nodes added, their inits and Slice samplers; MISS
    imputes y where ``y`` has missing (NaN) entries."""
    model, inputs, init = pkg.models.line.build()
    init = dict(init[0], y=np.array(y, dtype=float), **(inits or {}))
    inputs = dict(inputs, xmat=np.stack([np.ones(6), np.arange(1.0, 7.0)], 1),
                  w=np.linspace(-0.6, 0.9, 6), lo=np.linspace(-1.0, 0.5, 6))
    model = pkg.Model(**{**model.nodes, **(extra(pkg) if extra else {})})
    model.set_samplers([pkg.NUTS("beta"), pkg.Slice("s2", 3.0)]
                       + [pkg.Slice(n, 1.0) for n in samplers]
                       + ([pkg.MISS("y")] if np.isnan(y).any() else []))
    return model, inputs, init, None


def _line_tau(pkg):
    """(iv) tau's prior reads mean(y), y observed with no missing entry: a
    constant, evaluated whole once."""
    xp = _xp(pkg)
    return _six(pkg, lambda pkg: dict(
        ybar=pkg.Logical(lambda y: xp.mean(y), monitor=False),
        tau=pkg.Stochastic(lambda ybar: pkg.Normal(ybar, 1.0))),
        {"tau": 0.5}, ["tau"])


def _line_u(truncated):
    """(i) u (6,) named on the data axis, its prior reading w (and lo), a
    slice: Normal(w, 1), or Truncated(Normal(w, 1), lo, inf), whose
    bijector reads the slice lo."""
    def build(pkg):
        def u(pkg):
            if truncated:
                return dict(u=pkg.Stochastic(1, lambda w, lo: pkg.Truncated(
                    pkg.Normal(w, 1.0), lo, float("inf")), monitor=False))
            return dict(u=pkg.Stochastic(1, lambda w: pkg.Normal(w, 1.0),
                                         monitor=False))
        return _six(pkg, u, {"u": np.linspace(4.0, 5.5, 6)}, ["u"])
    return build


def _rats_centred(pkg):
    """(iv) y reads alpha - mean(alpha): alpha is a named sampled site,
    whole in the state, so the logical is computed whole and cut."""
    xp = _xp(pkg)
    model, inputs, inits, _ = _rats(pkg)
    centred = pkg.Model(**{
        **model.nodes,
        "alpha_c": pkg.Logical(1, lambda alpha: alpha - xp.mean(alpha),
                               monitor=False),
        "y": pkg.Stochastic(2, lambda alpha_c, beta, Xm, s2_c: pkg.Normal(
            alpha_c[:, None] + beta[:, None] * Xm[None, :], xp.sqrt(s2_c)),
            monitor=False)})
    centred.set_samplers(model.samplers)
    return centred, inputs, inits, None


def _birats(pkg):
    """(ii) beta (30, 2) ~ MvNormal per row, Y and beta named at dim 0."""
    model, inputs, inits = pkg.models.birats.build()
    return model, inputs, inits[0], None


def _ss_prior(pkg):
    """(a) tau's prior reads ss = sum((y - mu)**2), computed from the chain
    state (beta, through mu) and the data held in part: every rank gathers
    y's and mu's slices and computes ss whole, once per density call of
    beta's block (which moves mu), once per step of tau's."""
    xp = _xp(pkg)
    return dict(ss=pkg.Logical(lambda y, mu: xp.sum((y - mu) ** 2),
                               monitor=False),
                tau=pkg.Stochastic(lambda ss: pkg.Normal(0.1 * ss, 1.0)))


def _ybar_prior_pkg(pkg):
    xp = _xp(pkg)
    return dict(ybar=pkg.Logical(lambda y: xp.mean(y), monitor=False),
                tau=pkg.Stochastic(lambda ybar: pkg.Normal(ybar, 1.0)))


def _line_ss_tau(pkg):
    return _six(pkg, _ss_prior, {"tau": 0.5}, ["tau"])


def _line_miss_ybar(pkg):
    """(a) mean(y) with MISS imputing y's two missing entries: ybar moves
    with the chain state, so every rank gathers y and computes it whole,
    once per step of the blocks that read it."""
    return _six(pkg, _ybar_prior_pkg, {"tau": 0.5}, ["tau"], y=MISSING_Y)


def _line_v(pkg):
    """(c) v (6, 2) named at dim 0, its rows' law MvNormal(stack([w, w]),
    I) reading the slice of w: the data dim is a batch dim of the law."""
    xp = _xp(pkg)

    def v(pkg):
        return dict(v=pkg.Stochastic(2, lambda w: pkg.MvNormal(
            xp.stack([w, w], 1), xp.eye(2, dtype=w.dtype)), monitor=False))
    return _six(pkg, v, {"v": np.linspace(-1.0, 1.2, 12).reshape(6, 2)},
                ["v"])


def _birats_recycled(pkg):
    """(d) birats with one law for every row, beta ~ MvNormal(mu_beta,
    Sigma) recycled over the 30 rows: beta's value is cut along its rows."""
    model, inputs, inits = pkg.models.birats.build()
    nodes = dict(model.nodes)
    nodes["beta"] = pkg.Stochastic(2, lambda mu_beta, Sigma: pkg.MvNormal(
        mu_beta, Sigma), monitor=False)
    recycled = pkg.Model(**nodes)
    recycled.set_samplers(model.samplers)
    return recycled, inputs, inits[0], None


def _pad5(extra):
    """line's own five points padded to six over a data axis of two, with
    ``extra(pkg)``'s nodes added; the unsharded model's five points under
    ``UNPADDED``."""
    def build(pkg, unpadded=False):
        model, inputs, inits = pkg.models.line.build()
        model = pkg.Model(**{**model.nodes, **extra(pkg)})
        model.set_samplers([pkg.NUTS("beta"), pkg.Slice("s2", 3.0),
                            pkg.Slice("tau", 1.0)])
        init = dict(inits[0], tau=0.5)
        if unpadded:
            return model, inputs, init, None
        axes = {"chains": 1, "data": 2}
        p_in, _ = pad_axes(axes, LINE_SPECS, inputs)
        p_init, pads = pad_axes(axes, LINE_SPECS, init)
        return model, p_in, p_init, {"y": pad_mask(p_init["y"].shape,
                                                   pads["y"])}
    return build


def _glmm(fused):
    def build(pkg):
        model, inputs, inits, _ = pkg.models.glmm.build(G=G, n=10, seed=2,
                                                        fused=fused)
        return model, inputs, inits[0], None
    return build


def _states(init, rng):
    """C chains around ``init``: each continuous sampled site moved by a
    standard normal step (variances by a factor), data as it is (a missing
    entry imputed per chain)."""
    out = {}
    for k, v in init.items():
        v = np.asarray(v, dtype=float)
        if k in ("y", "Y"):
            out[k] = np.broadcast_to(v, (C,) + v.shape).copy()
            gap = np.isnan(out[k])
            out[k][gap] = 3.0 + rng.normal(size=int(gap.sum()))
        elif k.startswith("s2") or k in ("Sigma", "sigma2C"):
            out[k] = v * rng.gamma(4.0, 0.25, size=(C,) + (1,) * v.ndim)
        else:
            out[k] = v + rng.normal(size=(C,) + v.shape)
    return out


# name: (build, specs, block, {node: shape this rank holds, chains first})
CASES = {
    "line": (_line, LINE_SPECS, ("beta", "s2"),
             {"xmat": (3, 2), "y": (C, 3), "beta": (C, 2)}),
    # a named sampled site under NUTS or ChEES is the rank's slice too
    "rats": (_rats, RATS_SPECS, ("alpha", "beta", "mu_alpha", "mu_beta"),
             {"y": (C, 15, 5), "alpha": (C, 15), "beta": (C, 15),
              "Xm": (5,)}),
    "glmm_fused_y": (_glmm(True), GLMM_Y, ("beta", "z", "s2"),
                     {"y": (C, 10, 20), "xt": (4, 10, G), "z": (C, G)}),
    "glmm_fused_local": (_glmm(True), GLMM_LOCAL, ("beta", "z", "s2"),
                         {"y": (C, 10, 20), "xt": (4, 10, 20), "z": (C, 20)}),
    "glmm_generic": (_glmm(False), GLMM_GENERIC, ("beta", "z", "s2"),
                     {"y": (C, 20, 10), "x": (20, 10, 4), "z": (C, 20)}),
    # what the compiler refused before local views resolved it.  u under
    # Slice, and rats' alpha read by a centring logical, stay whole

    "line_tau": (_line_tau, LINE6_SPECS, ("beta", "s2", "tau"),
                 {"y": (C, 3), "tau": (C,)}),
    "line_u": (_line_u(False), U_SPECS, ("beta", "s2", "u"),
               {"y": (C, 3), "w": (3,), "u": (C, 6)}),
    "line_u_trunc": (_line_u(True), U_SPECS, ("beta", "s2", "u"),
                     {"y": (C, 3), "w": (3,), "lo": (3,), "u": (C, 6)}),
    "rats_centred": (_rats_centred, RATS_SPECS,
                     ("alpha", "beta", "mu_alpha", "mu_beta"),
                     {"y": (C, 15, 5), "alpha": (C, 30), "beta": (C, 15)}),
    "birats": (_birats, BIRATS_SPECS, ("beta", "mu_beta", "Sigma"),
               {"Y": (C, 15, 5), "beta": (C, 15, 2)}),
    # what the compiler refused before this and now takes: the GLMM with
    # only its data named (y reads its slice of the whole b), a prior that
    # reads a node gathered per density call (ss) or per step (mean(y)
    # under MISS), the same on line's own five points padded to six, rows
    # of a law with event dims whose prior reads a slice, and a law per
    # row recycled over the rows
    "glmm_fused_data": (_glmm(True), GLMM_DATA, ("beta", "z", "s2"),
                        {"y": (C, 10, 20), "xt": (4, 10, 20), "z": (C, G)}),
    "glmm_generic_data": (_glmm(False), GLMM_GENERIC_DATA, ("beta", "z", "s2"),
                          {"y": (C, 20, 10), "x": (20, 10, 4), "z": (C, G)}),
    "line_ss_tau": (_line_ss_tau, LINE6_SPECS, ("beta", "s2", "tau"),
                    {"y": (C, 3), "tau": (C,)}),
    "line_miss_ybar": (_line_miss_ybar, LINE6_SPECS, ("beta", "s2", "tau"),
                       {"y": (C, 3), "tau": (C,)}),
    "line_pad_ybar": (_pad5(_ybar_prior_pkg), LINE_SPECS, ("beta", "s2", "tau"),
                      {"y": (C, 3), "xmat": (3, 2), "tau": (C,)}),
    "line_pad_ss": (_pad5(_ss_prior), LINE_SPECS, ("beta", "s2", "tau"),
                    {"y": (C, 3), "xmat": (3, 2), "tau": (C,)}),
    "line_v": (_line_v, V_SPECS, ("beta", "s2", "v"),
               {"y": (C, 3), "w": (3,), "v": (C, 6, 2)}),
    "birats_recycled": (_birats_recycled, BIRATS_SPECS,
                        ("beta", "mu_beta", "Sigma"),
                        {"Y": (C, 15, 5), "beta": (C, 15, 2)}),
}
#: the padded cases: the unsharded model (line's own five points), which
#: the data ranks' parts are held to, and so is the JAX package's
UNPADDED = {"line_pad_ybar", "line_pad_ss"}


def _reference(case, pkg):
    """The unsharded model a case's parts are held to: the case itself, or
    for a padded case its model on the points as given."""
    build = CASES[case][0]
    return build(pkg, unpadded=True) if case in UNPADDED else build(pkg)


def _unpad(case, state, lead=1):
    """A case's state as its unsharded model holds it: each site cut to
    the shape the unpadded init gives (the padded tail dropped)."""
    if case not in UNPADDED:
        return state
    init = _reference(case, tmt)[2]
    return {k: v[(slice(None),) * lead + tuple(
        slice(0, n) for n in np.shape(init[k]))] for k, v in state.items()}


def _port(case):
    """The port's unsharded model, each data rank's, and a whole state as
    the ranks take it (padded, for a padded case: ``_unpad`` gives the
    unsharded model's)."""
    build, specs, block, _ = CASES[case]
    model, inputs, init, masks = build(tmt)
    ref = _reference(case, tmt)
    whole = tmt.compile_model(ref[0], ref[1], ref[2], device="cpu",
                              masks=ref[3])
    given = None
    if case in UNPADDED:
        given = {n: {d: g for d, (g, _) in p.items()}
                 for n, p in {**pad_axes({"chains": 1, "data": 2}, specs,
                                         ref[1])[1],
                              **pad_axes({"chains": 1, "data": 2}, specs,
                                         ref[2])[1]}.items()}
    ranks = [tmt.compile_model(model, inputs, init, device="cpu", masks=masks,
                               comm=_DataRank(r), site_specs=specs, pads=given)
             for r in (0, 1)]
    np_state = _states(init, np.random.default_rng(5))
    state = {k: torch.as_tensor(v) for k, v in np_state.items()}
    return whole, ranks, state, np_state


def _locals(ranks, state, xs=None, block=None, transform=True):
    """Each rank's local view of the whole ``state``, with the whole values
    of the gathered nodes' parents (``with_wholes``, its gather done by
    hand over the ranks): from the state, or from each rank's flat vector
    ``xs`` of ``block`` where given."""
    locals_ = [cm.cut_state(state) for cm in ranks]
    if not ranks[0]._gather_dims:
        return locals_
    if xs is None:
        slices = [torch.func.vmap(cm._parent_values)(st)
                  for cm, st in zip(ranks, locals_)]
    else:
        slices = [torch.func.vmap(cm.block_parents(block, transform))(x, st)
                  for cm, x, st in zip(ranks, xs, locals_)]
    wholes = ranks[0].join_wholes(slices)
    return [{**st, **wholes} for st in locals_]


def _rank_blocks(ranks, block, state, transform, xs):
    """Each rank's block value and gradient at its flat vector: a block
    that gathers per call (``block_gathers``) evaluates its density on the
    parents gathered from every rank's ``x``, sums the ranks' cotangents
    of them, and adds its slice of the sum pulled back (``block_pull``),
    as ``block_density`` does with its collectives."""
    per_call = ranks[0].block_gathers(block) == "call"
    locals_ = _locals(ranks, state, xs if per_call else None, block,
                      transform)
    if not per_call:
        return [_block(cm, block, st, transform, x)
                for cm, x, st in zip(ranks, xs, locals_)]
    parts = []
    for cm, x, st in zip(ranks, xs, locals_):
        logf = cm.block_functions(block, transform)[3]
        wholes = {k: v for k, v in st.items() if k.endswith("@whole")}
        base = {k: v for k, v in st.items() if k not in wholes}
        (gx, gw), v = torch.func.vmap(torch.func.grad_and_value(
            lambda x, s, w: logf(x, {**s, **w}), argnums=(0, 2)))(
            x, base, wholes)
        parts.append((base, v, gx, gw))
    total = {k: sum(p[3][k] for p in parts) for k in parts[0][3]}
    return [(x, v, gx + torch.func.vmap(cm.block_pull(block, transform))(
                x, base, total))
            for cm, x, (base, v, gx, _) in zip(ranks, xs, parts)]


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_only_its_slices(case):
    whole, ranks, state, _ = _port(case)
    want = CASES[case][3]
    for cm in ranks:
        local = cm.cut_state(state)
        held = {**cm.inputs, **local}
        assert {k: tuple(held[k].shape) for k in want} == want
        assert cm.local_state <= set(cm.sites)
        for k in cm.local_state:     # the rank's slice of the whole value
            np.testing.assert_array_equal(local[k], cm.local(k, state[k], 1))
    # the slices of the two ranks are the whole, in data-rank order (a
    # padded case's: the unsharded input and its padded tail)
    for k, layout in ranks[0].local_dims.items():
        if k in ranks[0].inputs:
            (d,) = layout
            joined = torch.cat([cm.inputs[k] for cm in ranks], d)
            np.testing.assert_array_equal(joined[tuple(
                slice(0, n) for n in whole.inputs[k].shape)], whole.inputs[k])


def _block(cm, block, state, transform, x=None):
    pack, _, _, logf = cm.block_functions(block, transform)
    if x is None:
        x = torch.func.vmap(pack)(state)
    g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, state)
    return x, v, g


def _joined(ranks, values, transform):
    """The join over the data group, done by hand: each rank's ``values``
    (block site -> chain-stacked), a site the ranks hold in part
    (``_held``), or whose prior reads slices under ``transform``
    (``block_maps``), joined along its dim."""
    out = {}
    for p in values[0]:
        d = ranks[0]._part_sites.get(p) if transform else None
        d = ranks[0]._held.get(p, d)
        out[p] = (values[0][p] if d is None
                  else torch.cat([v[p] for v in values], next(iter(d)) + 1))
    return out


def _scattered(cm, block, v):
    """A rank's chain-stacked per-coordinate ``v (C, rank dim)`` added into
    the unsharded flat order ``(C, dim)`` (zero elsewhere): summed over the
    ranks, the parts of a gradient give the whole one (each slice
    coordinate from its rank, each whole coordinate the ranks' sum)."""
    coords = cm.block_coords(block)
    if coords.index is None:
        return v
    out = v.new_zeros(v.shape[0], coords.dim)
    return out.index_add_(1, coords.index, v)


@pytest.mark.parametrize("case, transform", [
    (c, True) for c in CASES] + [("line", False), ("rats", False),
                                 ("line_u_trunc", False)])
def test_block_parts_sum_to_the_whole_and_to_the_reference(case, transform):
    """Each rank's block density and gradient from its local state, summed
    over the ranks: the port's whole model's (1e-12) and the JAX
    package's compiled block density (1e-10).  A rank packs and unpacks
    its coordinates of the flat vector (``block_coords``): the whole
    vector where the block holds no slice (a site whose prior reads
    slices: each rank its slice, joined); put in the unsharded order, the
    ranks' coordinates are the whole vector and their gradients sum to the
    whole gradient."""
    whole, ranks, state, np_state = _port(case)
    block = CASES[case][2]
    x, v, g = _block(whole, block, _unpad(case, state), transform)
    xs = []
    for cm in ranks:
        coords = cm.block_coords(block)
        xr = x if coords.index is None else x[:, coords.index]
        xs.append(xr)
        if coords.index is not None:    # the rank packs its coordinates
            np.testing.assert_array_equal(_block(
                cm, block, cm.cut_state(state), transform)[0], xr)
    parts = _rank_blocks(ranks, block, state, transform, xs)
    spec = whole.block_ravel_spec(block, transform)
    packed = _joined(ranks, [
        torch.func.vmap(lambda st, cm=cm: cm._flat_parts(block, transform, st))(
            cm.cut_state(state)) for cm in ranks], transform)
    np.testing.assert_array_equal(torch.func.vmap(spec.ravel)(packed), x)
    want = torch.func.vmap(whole.block_functions(block, transform)[1])(
        x, _unpad(case, state))
    got = _joined(ranks, [torch.func.vmap(
        cm.block_functions(block, transform)[1])(xr, cm.cut_state(state))
        for cm, (xr, _, _) in zip(ranks, parts)], transform)
    for p in block:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-14, err_msg=p)
    v_sum = parts[0][1] + parts[1][1]
    g_sum = sum(_scattered(cm, block, part[2])
                for cm, part in zip(ranks, parts))
    scale = float(g.abs().max())
    np.testing.assert_allclose(v_sum, v, rtol=1e-12)
    np.testing.assert_allclose(g_sum, g, rtol=1e-12, atol=1e-12 * scale)
    # the JAX package at the same state, chain by chain (a padded case: its
    # run without a mesh on the points as given)
    jax, jmt = _jax()
    model, inputs, init, masks = _reference(case, jmt)
    jcm = jmt.compile_model(model, inputs, init, masks=masks)
    jpack, _, _, jlogf = jcm.block_functions(block, transform)
    np_state = _unpad(case, np_state)
    for c in range(C):
        jst = {k: np.asarray(a[c]) for k, a in np_state.items()}
        jv, jg = jax.value_and_grad(jlogf)(jpack(jst), jst)
        np.testing.assert_allclose(float(v_sum[c]), float(jv), rtol=1e-10)
        np.testing.assert_allclose(g_sum[c], np.asarray(jg), rtol=1e-10,
                                   atol=1e-10 * scale)


@pytest.mark.parametrize("case", list(CASES))
def test_logpdf_parts_sum_to_the_whole_and_to_the_reference(case):
    whole, ranks, state, np_state = _port(case)
    want = torch.func.vmap(whole.logpdf)(_unpad(case, state))
    got = sum(torch.func.vmap(cm.logpdf_part)(st)
              for cm, st in zip(ranks, _locals(ranks, state)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    _, jmt = _jax()
    model, inputs, init, masks = _reference(case, jmt)
    jcm = jmt.compile_model(model, inputs, init, masks=masks)
    np_state = _unpad(case, np_state)
    for c in range(C):
        jst = {k: np.asarray(a[c]) for k, a in np_state.items()}
        np.testing.assert_allclose(float(got[c]), float(jcm.logpdf(jst)),
                                   rtol=1e-10)


def test_the_plans_of_the_fused_glmm():
    """With y alone named, the kernel runs over the rank's y and the
    covariates' slice cut once (``log_prob_range``); with y, xt and z
    named, over the rank's own arrays (``log_prob``), with no range, and
    the rank holds its slice of z (its prior's whole zeros cut)."""
    _, ranks, _, _ = _port("glmm_fused_y")
    plan = ranks[1]._local_plans["y"]
    assert plan[:3] == ("range", 20, 40) and plan[4] == 0
    assert plan[3].shape == (4, 10, 20) and plan[3].is_contiguous()
    _, ranks, _, _ = _port("glmm_fused_local")
    assert ranks[1]._local_plans["y"][0] == "local"
    assert ranks[1]._local_plans["z"][0] == "cut"
    assert ranks[1].local_dims == {"y": _on(1), "xt": _on(2), "z": _on(0),
                                   "b": _on(0)}
    assert ranks[1]._held == {"z": _on(0)}
    # with only y and xt named, z and b stay whole, and y reads the rank's
    # slice of b: the kernel runs over the rank's groups
    for case in ("glmm_fused_data", "glmm_generic_data"):
        _, ranks, _, _ = _port(case)
        for cm in ranks:
            assert cm._cuts == {"y": {"b": _on(0)}}, case
            assert cm._local_plans["y"][0] == "local" and not cm._held
            assert "b" not in cm.local_dims and "z" not in cm.local_dims
            assert cm.block_coords(("beta", "z", "s2")).index is None


# ---- what the compiler refuses ------------------------------------------
def _line_with(**nodes):
    """line's nodes, with ``nodes`` added; an input ``w`` (5,)."""
    model, inputs, inits = tline.build()
    model = tmt.Model(**{**model.nodes, **nodes})
    model.set_samplers([tmt.NUTS("beta"), tmt.Slice("s2", 3.0)]
                       + [tmt.Slice(n, 1.0) for n in nodes
                          if isinstance(nodes[n], StochasticNode)])
    return model, dict(inputs, w=np.arange(1.0, 6.0)), inits[0]


def _compile_rank(model, inputs, init, specs, r=1):
    return tmt.compile_model(model, inputs, init, device="cpu",
                             comm=_DataRank(r), site_specs=specs)


def test_a_term_that_reads_mean_y_is_refused_by_name():
    """(iv) tau's prior reads mean(y), y observed and named on the data
    axis.  y has no missing entry, so mean(y) reads only constants: the
    compiler evaluates it whole once, before the rank drops its slices,
    and every rank holds the whole value (its parts of every term:
    ``CASES["line_tau"]``).  What stays refused, by name: a prior that
    reads a node computed from the chain state and data held in part
    together (sum((y - mu)**2)), which inside the vmapped density would
    need a collective per call."""
    model, inputs, init, _ = _line_tau(tmt)
    for r in (0, 1):
        cm = _compile_rank(model, inputs, init, LINE6_SPECS, r)
        assert set(cm._consts) == {"ybar"} and not cm.mixed
        assert "ybar" not in cm.local_dims
        np.testing.assert_allclose(cm._consts["ybar"][0], init["y"].mean(),
                                   rtol=1e-15)
        assert cm.const_data == {"y"}
        _chain_inits(cm, [init, init], 2)
        with pytest.raises(ValueError, match="chain 1: the data 'y' differ"):
            _chain_inits(cm, [init, dict(init, y=init["y"] + 1.0)], 2)
    # a prior that reads ss = sum((y - mu)**2), computed from the chain
    # state and the data held in part: every rank computes ss whole from y
    # and mu gathered over the data group, once per density call of beta's
    # block (which moves mu), once per step of tau's (its parts against the
    # whole: ``CASES["line_ss_tau"]``)
    model, inputs, init, _ = _line_ss_tau(tmt)
    for r in (0, 1):
        cm = _compile_rank(model, inputs, init, LINE6_SPECS, r)
        assert cm._gathered == {"ss": {"y": _on(0), "mu": _on(0)}} and cm.mixed == {"ss"}
        assert cm.block_gathers(("beta",)) == "call"
        assert cm.block_gathers(("tau",)) == "step"
        assert cm.block_gathers(("s2",)) == ""
        assert cm.block_split(("beta",)) and not cm.block_split(("tau",))
        np.testing.assert_array_equal(
            cm._example_wholes["y@whole"], init["y"])
    # unsharded, and over a data axis with y whole, the model compiles
    _compile_rank(model, inputs, init, {})


def test_a_centering_logical_at_symmetric_inits_is_refused_by_name():
    """(iv) rats' y reads alpha - mean(alpha), alpha named on the data
    axis.  The inits set alpha to 250 on every rat, where the centring is
    0 whole and on each slice; the compiler checks at its probe state,
    where alpha is not symmetric.  alpha is a sampled site, whole in the
    state, so the logical reads only whole state values: it is computed
    from the whole alpha and cut to the rank's rats, which y reads."""
    model, inputs, init, _ = _rats_centred(tmt)
    assert np.all(init["alpha"] == 250.0)
    state = _states(init, np.random.default_rng(2))
    alpha = torch.as_tensor(state["alpha"])
    for r in (0, 1):
        cm = _compile_rank(model, inputs, init, RATS_SPECS, r)
        assert cm._recut == {"alpha_c": _on(0)} and not cm.mixed
        assert cm.local_dims["alpha_c"] == _on(0)
        local = cm.cut_state({k: torch.as_tensor(v) for k, v in state.items()})
        got = torch.func.vmap(cm.eval_logicals)(local)["alpha_c"]
        want = alpha - alpha.mean(1, keepdim=True)
        np.testing.assert_allclose(got, want[:, 15 * r:15 * r + 15],
                                   rtol=1e-14)
    _compile_rank(model, inputs, init, {})
    # through a logical that comes out a slice: it reads only whole state
    # values too, so it is computed whole once and cut
    model = tmt.Model(**{
        **model.nodes, "a2": tmt.Logical(1, lambda alpha: 2.0 * alpha,
                                         monitor=False),
        "alpha_c": tmt.Logical(1, lambda a2: 0.5 * (a2 - torch.mean(a2)),
                               monitor=False)})
    model.set_samplers(_rats_centred(tmt)[0].samplers)
    for r in (0, 1):
        cm = _compile_rank(model, inputs, init, RATS_SPECS, r)
        assert cm._recut == {"alpha_c": _on(0), "a2": _on(0)} and not cm.mixed
        local = cm.cut_state({k: torch.as_tensor(v) for k, v in state.items()})
        got = torch.func.vmap(cm.eval_logicals)(local)["alpha_c"]
        np.testing.assert_allclose(got, want[:, 15 * r:15 * r + 15],
                                   rtol=1e-13)


def test_a_term_that_reads_mean_y_is_refused_when_y_has_missing_entries():
    """y with missing entries under MISS: mean(y) at the example inits is
    NaN whole and on each slice.  The probe state draws the missing
    entries, where mean(y) differs on each slice: it moves with the chain
    state, so every rank gathers y and computes it whole, once per step of
    tau's block, which does not move y (the parts against the whole:
    ``CASES["line_miss_ybar"]``)."""
    model, inputs, inits = _line6("miss", MISSING_Y)
    with_tau = tmt.Model(**{
        **model.nodes,
        "ybar": tmt.Logical(lambda y: torch.mean(y), monitor=False),
        "tau": tmt.Stochastic(lambda ybar: tmt.Normal(ybar, 1.0))})
    with_tau.set_samplers(model.samplers + [tmt.Slice("tau", 1.0)])
    init = dict(inits[0], tau=0.0)
    for r in (0, 1):
        cm = _compile_rank(with_tau, inputs, init, LINE6_SPECS, r)
        assert cm._gathered == {"ybar": {"y": _on(0)}} and not cm._consts
        # MISS moves y, so a density of its block would gather per call;
        # it draws y from y's law, which does not read ybar
        assert [cm.block_gathers(s.params) for s in with_tau.samplers] == [
            "", "", "call", "step"]
        assert cm.block_prepare(("tau",)) == cm.with_wholes
        assert cm.block_prepare(("beta",))({"beta": 1}) == {"beta": 1}
    _compile_rank(with_tau, inputs, init, {})


def test_a_density_that_is_not_finite_at_the_probe_is_refused_by_name():
    """y2 = 50 under Uniform(0, theta): finite at the example's theta = 60,
    -inf at the probe's theta (a standard normal's exp), where no part of
    the model could be checked."""
    model, init = _conjugate()
    model = tmt.Model(**{
        **model.nodes,
        "y2": tmt.Stochastic(1, lambda theta: tmt.Uniform(0.0, theta),
                             monitor=False),
        "theta": tmt.Stochastic(lambda: tmt.Gamma(2.0, 1.0))})
    model.set_samplers([tmt.NUTS("mu"), tmt.Slice("theta", 1.0)])
    init = dict(init, y2=np.array([50.0]), theta=60.0)
    with pytest.raises(ValueError, match=r"density of 'y2' is -inf at the probe"):
        _compile_rank(model, {}, init, {"y": ("data",)})
    _compile_rank(model, {}, init, {})


def test_what_reads_a_slice_where_it_cannot_is_refused_by_name():
    """What the compiler refused before and now takes: a monitored
    mean(y) (a constant, whole), a monitored node computed from the chain
    state and slices (mixed: a monitor or a Gibbs block computes it again
    from whole values, across two gloo ranks below) and a sampled site
    named on the data axis whose prior reads a slice.  What it still
    refuses, by name."""
    model, inputs, init = _line_with(
        ybar=tmt.Logical(lambda y: torch.mean(y)),
        ss=tmt.Logical(lambda y, mu: torch.sum((y - mu) ** 2)))
    init = dict(init, y=np.array([1.0, 3.0, 3.0, 3.0, 5.0, 5.0]))
    inputs["xmat"] = np.stack([np.ones(6), np.arange(1.0, 7.0)], 1)
    specs = {"y": ("data",), "xmat": ("data", None)}
    cm = _compile_rank(model, inputs, init, specs)
    assert cm.mixed == {"ss"} and set(cm._consts) == {"ybar"}
    nodes = torch.func.vmap(cm.eval_logicals)(
        cm.cut_state({k: torch.as_tensor(np.asarray(v, float))[None]
                      for k, v in init.items()}))
    env = WholeValues(cm, cm.inputs, nodes)
    assert env["s2"].shape == (1,)               # whole, read as it is
    np.testing.assert_allclose(env["ybar"], [init["y"].mean()], rtol=1e-15)
    with pytest.raises(ValueError, match="node 'ss'.*WholeValues"):
        cm.whole("ss", nodes["ss"], 1)
    # a sampled site on the data axis whose prior reads a slice
    cm = _compile_rank(*_line_u(True)(tmt)[:3], U_SPECS)
    assert cm._part_sites == {"u": _on(0)}
    # ... one whose law has event dims too, where the data dim is a batch
    # dim of its law: its rows (``CASES["line_v"]``)
    for r in (0, 1):
        cm = _compile_rank(*_line_v(tmt)[:3], V_SPECS, r)
        assert cm._part_sites == {"v": _on(0)}
        assert cm._local_plans["v"][0] == "local"
    # a law per row whose batch does not hold the data dim is recycled over
    # the rows: each rank's part is the law on its rows
    # (``CASES["birats_recycled"]``)
    model, inputs, init, _ = _birats_recycled(tmt)
    for r in (0, 1):
        cm = _compile_rank(model, inputs, init, BIRATS_SPECS, r)
        assert cm._local_plans["beta"][0] == "local"
        assert cm._held == {"beta": _on(0)}
    # the generic GLMM with y and x named but not z: b stays whole, and y
    # reads the rank's slice of it (``CASES["glmm_generic_data"]``)
    model, inputs, inits, _ = tglmm.build(G=G, n=10, seed=2)
    cm = _compile_rank(model, inputs, inits[0], GLMM_GENERIC_DATA)
    assert cm._cuts == {"y": {"b": _on(0)}}
    # a spec that names the chain axis, or a length that does not divide
    with pytest.raises(ValueError, match="names the chain axis"):
        _compile_rank(model, inputs, inits[0], {"y": ("chains", None)})
    with pytest.raises(ValueError, match="does not divide"):
        _compile_rank(*tline.build()[:2], tline.build()[2][0], LINE_SPECS)


def _padded(**nodes):
    """line's own five points, padded to six over a data axis of two, with
    ``nodes`` added (``_line_with``): the model, the padded inputs and
    init, the masks and each padded dim's length as given."""
    model, inputs, init = _line_with(**nodes)
    init = dict(init, tau=0.5)
    axes = {"chains": 1, "data": 2}
    p_in, in_pads = pad_axes(axes, LINE_SPECS, inputs)
    p_init, pads = pad_axes(axes, LINE_SPECS, init)
    masks = {"y": pad_mask(p_init["y"].shape, pads["y"])}
    given = {n: {d: g for d, (g, _) in p.items()}
             for n, p in {**in_pads, **pads}.items()}
    return model, inputs, init, (p_in, p_init, masks, given)


def _ybar_prior():
    return dict(ybar=tmt.Logical(lambda y: torch.mean(y), monitor=False),
                tau=tmt.Stochastic(lambda ybar: tmt.Normal(ybar, 1.0)))


def _ss(monitor):
    return dict(ss=tmt.Logical(lambda y, mu: torch.sum((y - mu) ** 2),
                               monitor=monitor))


#: nodes that read the whole of a padded array: (nodes, the node, the
#: padded arrays it reads, whether it is a constant)
PADDED = {"prior": (_ybar_prior, "ybar", ["y"], True),
          "monitor": (lambda: _ss(True), "ss", ["xmat", "y"], False),
          "gibbs": (lambda: _ss(False), "ss", ["xmat", "y"], False)}


@pytest.mark.parametrize("case", list(PADDED))
def test_what_reads_the_whole_of_a_padded_array_is_refused_by_name(case):
    """line's own five points on a data axis of two: y and xmat padded to
    six.  mean(y) read by a prior (a constant) and ss = sum((y - mu)**2),
    monitored or read by a Gibbs block, are computed from the arrays as
    given, their padded tails dropped: each is the unsharded model's value
    (the compiler refused them before).  ss is computed by ``WholeValues``
    from the whole (padded) values that each rank gathers, here handed
    over as ``cm.whole`` would gather them."""
    nodes, name, padded, is_const = PADDED[case]
    model, inputs, init, (p_in, p_init, masks, given) = _padded(**nodes())

    def stacked(values):
        return {k: torch.as_tensor(np.asarray(v, float))[None]
                for k, v in values.items()}
    whole = tmt.compile_model(model, inputs, init, device="cpu")
    want = torch.func.vmap(whole.eval_logicals)(stacked(init))[name]
    padded_cm = tmt.compile_model(model, p_in, p_init, device="cpu",
                                  masks=masks)
    full = {**padded_cm.inputs,
            **torch.func.vmap(padded_cm.eval_logicals)(stacked(p_init))}
    for r in (0, 1):
        cm = tmt.compile_model(model, p_in, p_init, device="cpu",
                               masks=masks, comm=_DataRank(r),
                               site_specs=LINE_SPECS, pads=given)
        assert cm.padded_reads(name) == padded
        if is_const:
            assert set(cm._consts) == {name} and not cm.mixed
            np.testing.assert_allclose(cm._consts[name][1], want[0],
                                       rtol=1e-15)
            continue
        assert cm.mixed == {name} and not cm._gathered
        nodes_r = torch.func.vmap(cm.eval_logicals)(cm.cut_state(
            stacked(p_init)))
        cm.whole = lambda n, x, lead=0: full[n]
        np.testing.assert_allclose(WholeValues(cm, cm.inputs, nodes_r)[name],
                                   want, rtol=1e-14)
    tmt.compile_model(model, inputs, init, device="cpu")


def test_a_padded_length_that_another_array_has_as_given_is_taken():
    """line's own five points padded to six, and w named with six entries
    as given: 6 is y's padded length and w's real one.  Each array's
    padding is its own record (``_padded``: y's and xmat's from ``pads``,
    mu's from xmat's), not a length, so mean(y) is computed from y as
    given and w is not trimmed; with or without mean(y) the model
    compiles, and its parts are held to the unsharded model in
    tests/test_torch_gathered_terms.py."""
    for extra, reads_ybar in ((_ybar_prior_pkg, True), (lambda pkg: dict(
            tau=pkg.Stochastic(lambda: pkg.Normal(0.0, 1.0))), False)):
        model, inputs, init, masks = _pad5(extra)(tmt)
        ref = _pad5(extra)(tmt, True)
        model = tmt.Model(**{**model.nodes, "u": tmt.Stochastic(
            1, lambda w: tmt.Normal(w, 1.0), monitor=False)})
        model.set_samplers(ref[0].samplers + [tmt.Slice("u", 1.0)])
        inputs = dict(inputs, w=np.linspace(-0.6, 0.9, 6))
        init = dict(init, u=np.zeros(6))
        specs = {**LINE_SPECS, "w": ("data",), "u": ("data",)}
        pads = {"y": {0: 5}, "xmat": {0: 5}}
        for r in (0, 1):
            cm = tmt.compile_model(model, inputs, init, device="cpu",
                                   masks=masks, comm=_DataRank(r),
                                   site_specs=specs, pads=pads)
            assert cm._padded["y"] == cm._padded["xmat"] == {0: (5, 6)}
            assert "w" not in cm._padded and "u" not in cm._padded
            if reads_ybar:
                np.testing.assert_allclose(
                    cm._consts["ybar"][1], np.mean(ref[2]["y"]), rtol=1e-15)


def _rolled_glmm(fused):
    """The GLMM with only its data named, whose y reads b moved by one
    group: no cut of b gives a data rank the groups its slice needs."""
    model, inputs, inits, _ = tglmm.build(G=G, n=10, seed=2, fused=fused)
    if fused:
        from mamba_tpu_torch.ops.fused_glmm import BernoulliLogitGLMM
        y = tmt.Stochastic(2, lambda xt, beta, b: BernoulliLogitGLMM(
            xt, beta, torch.roll(b, 1)), monitor=False)
    else:
        y = tmt.Stochastic(2, lambda x, beta, b: tmt.Bernoulli(torch.sigmoid(
            torch.einsum("gnp,p->gn", x, beta)
            + torch.roll(b, 1)[:, None])), monitor=False)
    rolled = tmt.Model(**{**model.nodes, "y": y})
    rolled.set_samplers(model.samplers)
    return rolled, inputs, inits[0]


#: what stays refused: (model, inputs, init), site_specs and the message
STAYS_REFUSED = {
    "fused_glmm_probe_mismatch": (lambda: _rolled_glmm(True), GLMM_DATA,
                                  r"the density of 'y' cannot be evaluated"),
    "generic_glmm_probe_mismatch": (lambda: _rolled_glmm(False),
                                    GLMM_GENERIC_DATA,
                                    r"the density of 'y' cannot be evaluated"),
    "chain_axis": (lambda: _line_v(tmt)[:3], {"y": ("chains",)},
                   r"names the chain axis 'chains'"),
}


@pytest.mark.parametrize("case", list(STAYS_REFUSED))
def test_what_stays_refused_raises_a_value_error_that_names_it(case):
    """What the data axis still refuses, each by a ValueError that names
    the node or the axis, never a raw error of the evaluation: the GLMM
    whose parts no cut of its whole b confirms at the probe (the fused
    kernel's shape error, the generic form's broadcast) and a spec that
    names the chain axis.  (Several data axes, and an axis named on two
    dims: tests/test_torch_data_axes.py.  A named site whose data dims cut
    an event of its law, and a named term that reads a node its block
    gathers per density call, are taken: tests/test_torch_gathered_terms
    .py.)"""
    build, specs, message = STAYS_REFUSED[case]
    model, inputs, init = build()
    with pytest.raises(ValueError, match=message):
        _compile_rank(model, inputs, init, specs)
    tmt.compile_model(model, inputs, init, device="cpu")


# ---- forward_sample -----------------------------------------------------
def _conjugate():
    """y (8,) ~ Normal(mu, 1): y's distribution reads only mu."""
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu: tmt.Normal(mu.expand(8), 1.0),
                         monitor=False),
        mu=tmt.Stochastic(lambda: tmt.Normal(0.0, math.sqrt(2.0))))
    model.set_samplers([tmt.NUTS("mu")])
    return model, {"y": np.linspace(0.5, 1.5, 8), "mu": 0.0}


def test_forward_sample_keeps_the_slice_of_the_unsharded_draw():
    model, init = _conjugate()
    whole = tmt.compile_model(model, {}, init, device="cpu")
    state = _chain_inits(whole, init, 5)
    state["mu"] = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)
    gen = R.chain_keys(11, range(5))
    want = whole.forward_sample(gen, state, names=("y", "mu"))
    for r in (0, 1):
        cm = _compile_rank(model, {}, init, {"y": ("data",)}, r)
        local = cm.cut_state(state)
        assert local["y"].shape == (5, 4)
        np.testing.assert_array_equal(_chain_inits(cm, init, 5)["y"],
                                      local["y"])
        got = cm.forward_sample(gen, local, names=("y", "mu"))
        assert got["y"].shape == (5, 4) and got["y"].is_contiguous()
        np.testing.assert_array_equal(got["y"], want["y"][:, 4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["mu"], want["mu"])


def test_a_slice_of_padding_alone_adds_nothing():
    """Five observations over four data ranks pad to eight: rank 3 holds
    padding alone, and its part of y is exactly 0."""
    model, init = _conjugate()
    model.nodes["y"] = tmt.Stochastic(1, lambda mu: tmt.Normal(mu, 1.0),
                                      monitor=False)
    init = dict(init, y=np.linspace(0.5, 1.5, 5))
    whole = tmt.compile_model(model, {}, init, device="cpu")
    p_init, pads = pad_axes({"chains": 1, "data": 4}, {"y": ("data",)}, init)
    masks = {"y": pad_mask(p_init["y"].shape, pads["y"])}

    class Rank(_DataRank):
        data_size = 4
    state = {"y": torch.as_tensor(p_init["y"])[None],
             "mu": torch.tensor([0.3], dtype=torch.float64)}
    parts = []
    for r in range(4):
        cm = tmt.compile_model(model, {}, p_init, device="cpu", masks=masks,
                               comm=Rank(r), site_specs={"y": ("data",)})
        parts.append(torch.func.vmap(cm.logpdf_part)(cm.cut_state(state)))
        if r == 3:
            assert cm._local_plans["y"] == ("zero",)
            assert float(parts[-1]) == 0.0
    want = whole.logpdf({"y": torch.as_tensor(init["y"]), "mu": state["mu"][0]})
    np.testing.assert_allclose(float(sum(parts)), float(want), rtol=1e-12)


# ---- across two gloo ranks ----------------------------------------------
def _line6(samplers="nuts", y=(1.0, 3.0, 3.0, 3.0, 5.0, 6.0)):
    """line on six points (the data axis divides them), y monitored; its
    samplers: NUTS + Slice, with MISS on y, or ABC on beta + Slice."""
    y = np.asarray(y, dtype=float)
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu, s2: tmt.Normal(mu, torch.sqrt(s2))),
        mu=tmt.Logical(1, lambda xmat, beta: xmat @ beta, monitor=False),
        beta=tmt.Stochastic(1, lambda: tmt.Normal(torch.zeros(2),
                                                  math.sqrt(1000.0))),
        s2=tmt.Stochastic(lambda: tmt.InverseGamma(0.001, 0.001)))
    blocks = {"nuts": [tmt.NUTS("beta"), tmt.Slice("s2", 3.0)],
              "miss": [tmt.NUTS("beta"), tmt.Slice("s2", 3.0), tmt.MISS("y")],
              "abc": [tmt.ABC("beta", 0.3, lambda v: v, 1.0, kernel="normal",
                              maxdraw=4, nsim=2), tmt.Slice("s2", 3.0)]}
    model.set_samplers(blocks[samplers])
    inputs = {"xmat": np.stack([np.ones(6), np.arange(1.0, 7.0)], 1)}
    inits = [{"y": y, "beta": np.array([0.5, 0.7]), "s2": 1.5},
             {"y": y, "beta": np.array([-0.5, 1.0]), "s2": 0.5}]
    return model, inputs, inits


MISSING_Y = (1.0, np.nan, 3.0, 3.0, np.nan, 6.0)
RUN = dict(chains=4, seed=3, device="cpu", verbose=False)


def _runs(mesh=None):
    """The readers' runs: line6 under NUTS (then its modelstats), MISS
    and ABC."""
    kw = dict(RUN, mesh=mesh, site_specs=LINE6_SPECS if mesh else None)
    sim = tmt.mcmc(*_line6(), 30, burnin=10, **kw)
    miss = tmt.mcmc(*_line6("miss", MISSING_Y), 20, burnin=5, **kw)
    abc = tmt.mcmc(*_line6("abc"), 12, burnin=4, **kw)
    return {"value": sim.value, "dic": tmt.dic(sim).value,
            "logpdf": tmt.logpdf_chains(sim).value,
            "predict": tmt.predict(sim, seed=1).value,
            "miss": miss.value, "abc": abc.value,
            "shapes": json.dumps([list(sim.compiled.inputs["xmat"].shape),
                                  list(sim.states["state"]["y"].shape),
                                  list(miss.states["state"]["y"].shape),
                                  list(sim.states["state"]["beta"].shape)])}


def _rats_gibbs(mesh=None):
    """One step of rats' conjugate Gibbs block (y, alpha and beta named)
    from the chains' inits: its draws of the three variances."""
    model, inputs, inits = trats.build("nuts")
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu",
                           comm=tmt.parallel.mesh.MeshComm(mesh),
                           site_specs=RATS_SPECS if mesh else None)
    state = _chain_inits(cm, inits, 4)
    gen = R.chain_keys(9, range(4))
    new, _ = model.samplers[1].build(cm).step(gen, state, (), False)
    return {"s2": torch.stack([new[k] for k in
                               ("s2_c", "s2_alpha", "s2_beta")]).numpy(),
            "y_shape": np.array(state["y"].shape)}


def _line_ss():
    """(iii) line6 with ss = sum((y - mu)**2) monitored, a node computed
    from the chain state and slices (mixed), and s2 drawn by a conjugate
    Gibbs block that reads ss whole."""
    model, inputs, init, _ = _six(tmt, lambda pkg: dict(
        ss=tmt.Logical(lambda y, mu: torch.sum((y - mu) ** 2))))

    def s2_gibbs(key, env):
        ss = env["ss"]                                    # (chains,)
        return {"s2": R.inverse_gamma_bounded(key, 0.001 + 3.0,
                                              0.001 + 0.5 * ss)}
    model.set_samplers([tmt.NUTS("beta"), tmt.Gibbs("s2", s2_gibbs)])
    return model, inputs, init


#: the resolved cases' runs: (build, site_specs, iterations, burnin); a
#: padded case is given line's own five points, which mcmc pads
CASE_RUNS = {"line_tau": (lambda: _line_tau(tmt)[:3], LINE6_SPECS, 30, 10),
             "line_u_trunc": (lambda: _line_u(True)(tmt)[:3], U_SPECS, 30, 10),
             "rats_centred": (lambda: _rats_centred(tmt)[:3], RATS_SPECS, 4, 2),
             "birats": (lambda: _birats(tmt)[:3], BIRATS_SPECS, 6, 3),
             "line_ss": (_line_ss, LINE6_SPECS, 30, 10)}
#: the same for the cases the compiler refused before it read whole parents
#: cut, gathered nodes and dropped padded tails
TAKEN_RUNS = {"glmm_fused_data": (lambda: _glmm(True)(tmt)[:3], GLMM_DATA, 8, 4),
             "glmm_generic_data": (lambda: _glmm(False)(tmt)[:3],
                                   GLMM_GENERIC_DATA, 8, 4),
             "line_ss_tau": (lambda: _line_ss_tau(tmt)[:3], LINE6_SPECS, 30,
                             10),
             "line_miss_ybar": (lambda: _line_miss_ybar(tmt)[:3], LINE6_SPECS,
                                30, 10),
             "line_pad_ybar": (lambda: _pad5(_ybar_prior_pkg)(tmt, True)[:3],
                               LINE_SPECS, 30, 10),
             "line_pad_ss": (lambda: _pad5(_ss_prior)(tmt, True)[:3],
                             LINE_SPECS, 30, 10),
             "line_v": (lambda: _line_v(tmt)[:3], V_SPECS, 20, 10),
             "birats_recycled": (lambda: _birats_recycled(tmt)[:3],
                                 BIRATS_SPECS, 6, 3)}
#: the cases whose beta block gathers ss once per density call: their
#: block density and gradient are held to the unsharded grad_and_value
PER_CALL = ("line_ss_tau", "line_pad_ss")
PER_CALL_BLOCK = ("beta", "s2", "tau")


def _case_runs(mesh=None, runs=CASE_RUNS):
    out = {}
    for name, (build, specs, iters, burnin) in runs.items():
        model, inputs, init = build()
        sim = tmt.mcmc(model, inputs, [init], iters, burnin=burnin,
                       site_specs=specs if mesh else None,
                       **dict(RUN, mesh=mesh))
        out[name] = sim.value
        if name == "line_ss":
            out["ss_names"] = np.array(sim.names)
    return out


def _spread(init):
    """Four chains' inits around ``init``: beta and tau moved."""
    return [dict(init, beta=np.asarray(init["beta"]) + 0.3 * i,
                 tau=0.5 + 0.2 * i) for i in range(4)]


def _per_call_density(name, mesh=None):
    """The block density and gradient of ``PER_CALL_BLOCK`` at four chains:
    on ``mesh``'s data rank through ``block_density`` (its gather and
    all-reduce), else the unsharded model's ``grad_and_value``."""
    from mamba_tpu_torch.model.mcmc import _pad_sharded
    model, inputs, init = TAKEN_RUNS[name][0]()
    specs = TAKEN_RUNS[name][1]
    if mesh is None:
        cm = tmt.compile_model(model, inputs, init, device="cpu")
        state = _chain_inits(cm, _spread(init), 4)
        pack, _, _, logf = cm.block_functions(PER_CALL_BLOCK, True)
        g, v = torch.func.vmap(torch.func.grad_and_value(logf))(
            torch.func.vmap(pack)(state), state)
        return v, g
    inputs, inits, masks, pads = _pad_sharded(model, mesh, specs, inputs,
                                              _spread(init))
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu", masks=masks,
                           comm=tmt.parallel.mesh.MeshComm(mesh),
                           site_specs=specs, pads=pads)
    assert cm.block_gathers(PER_CALL_BLOCK) == "call"
    state = _chain_inits(cm, inits, 4)
    x = cm.block_maps(PER_CALL_BLOCK, True)[0](state)
    return cm.block_density(PER_CALL_BLOCK, True, grad=True)(x, state)


def _mode_cases(rank):
    return _case_runs(make_mesh({"chains": 1, "data": 2}, "cpu"))


def _mode_taken(rank):
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    out = _case_runs(mesh, TAKEN_RUNS)
    for name in PER_CALL:
        out[f"{name}_v"], out[f"{name}_g"] = _per_call_density(name, mesh)
    return out


def _mode_readers(rank):
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    return {**_runs(mesh), **_rats_gibbs(mesh)}


def _ranks(mode, tmp_path, n=2):
    env = dict(os.environ, MULTIPROC_OUT=str(tmp_path))
    run_ranks(lambda r, init: [sys.executable, __file__, init, n, r, mode],
              n, timeout=RANKS_TIMEOUT, env=env)
    return [dict(np.load(tmp_path / f"{mode}{r}.npz")) for r in range(n)]


def test_readers_of_whole_values_on_two_data_ranks(tmp_path):
    r0, r1 = _ranks("readers", tmp_path)
    ref = {**_runs(), **_rats_gibbs()}
    for res in (r0, r1):
        # xmat's rows, y's entries (MISS's too) halved; beta whole
        assert json.loads(str(res["shapes"])) == [[3, 2], [4, 3], [4, 3], [4, 2]]
        assert res["y_shape"].tolist() == [4, 15, 5]
    for k in ("value", "dic", "logpdf", "predict", "miss", "abc", "s2"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        # the same random stream; only the density's summation order differs
        np.testing.assert_allclose(r0[k], ref[k], rtol=1e-8, err_msg=k)
    # the Gibbs block reads y whole: the unsharded draw, bit for bit
    np.testing.assert_array_equal(r0["s2"], ref["s2"])
    assert r0["value"].shape[1] == 9         # beta, s2 and y's six entries
    # y monitored and gathered (columns 3-8, after beta and s2): its data
    # as given, its two missing entries imputed and moving
    miss = r0["miss"]
    assert np.isfinite(miss).all()
    y = np.asarray(MISSING_Y)
    np.testing.assert_array_equal(
        miss[:, 3:][:, ~np.isnan(y)],
        np.broadcast_to(y[~np.isnan(y)][:, None], miss[:, 3:][:, ~np.isnan(y)].shape))
    assert miss[:, 3:][:, np.isnan(y)].std((0, 2)).min() > 0


def test_resolved_cases_on_two_data_ranks_match_the_unsharded_runs(tmp_path):
    """(i)-(iv) across two gloo ranks against the runs without a mesh: a
    prior reading mean(y), a sampled site whose truncated prior reads
    slices, rats' centring logical, birats' law per row, and line's
    monitored ss that a Gibbs block reads whole (1e-8).  (On line's own
    five points, padded by the data axis, mean(y) read by a prior is now
    the unsharded run's: ``TAKEN_RUNS["line_pad_ybar"]``.)"""
    r0, r1 = _ranks("cases", tmp_path)
    ref = _case_runs()
    assert list(r0["ss_names"]) == list(ref["ss_names"]) == [
        "beta[1]", "beta[2]", "s2", "ss"]
    for k in CASE_RUNS:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        assert np.isfinite(r0[k]).all(), k
        np.testing.assert_allclose(r0[k], ref[k], rtol=1e-8, err_msg=k)
    ss = r0["line_ss"][:, 3]                     # moves with the state
    assert ss.std() > 0


def test_taken_cases_on_two_data_ranks_match_the_unsharded_runs(tmp_path):
    """Across two gloo ranks against the runs without a mesh (1e-8): the
    GLMM with only its data named (fused and generic), a prior reading ss
    gathered per density call, one reading mean(y) gathered per step under
    MISS, both priors on line's own five points, which the data axis pads
    (held to the unsharded run on the five points, not to a count of the
    padding), the v rows and birats' recycled law; draws equal on both
    ranks.  The block density and gradient of a block that gathers per
    call (its all-gather, its vjp and its all-reduce), against the
    unsharded grad_and_value (1e-10)."""
    r0, r1 = _ranks("taken", tmp_path)
    ref = _case_runs(runs=TAKEN_RUNS)
    for name in PER_CALL:
        v, g = _per_call_density(name)
        for res in (r0, r1):
            np.testing.assert_allclose(res[f"{name}_v"], v, rtol=1e-10)
            np.testing.assert_allclose(res[f"{name}_g"], g, rtol=1e-10,
                                       atol=1e-10 * float(g.abs().max()))
    for k in TAKEN_RUNS:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        assert np.isfinite(r0[k]).all(), k
        np.testing.assert_allclose(r0[k], ref[k], rtol=1e-8, err_msg=k)
    for k in ("line_ss_tau", "line_miss_ybar", "line_pad_ybar", "line_pad_ss"):
        assert r0[k][:, 3].std() > 0, k          # tau moves


def _main(argv) -> int:
    from mamba_tpu_torch.parallel import distributed_init
    init, n, rank, mode = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    distributed_init(init, n, rank, device_type="cpu", timeout=GROUP_TIMEOUT)
    try:
        out = {"readers": _mode_readers, "cases": _mode_cases,
               "taken": _mode_taken}[mode](rank)
        np.savez(Path(os.environ["MULTIPROC_OUT"]) / f"{mode}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
