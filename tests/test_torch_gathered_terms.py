"""The last layouts the data axis refused, taken as GSPMD takes them in the
JAX package:

- a named term that reads a node its block gathers per density call: the
  sum-to-zero random effect ``b = sqrt(s2) * (z - mean(z))`` of the GLMM
  with y, its covariates and z named (each rank's y reads its groups of
  the whole b), and line's y2 reading ss = sum((y - mu)**2).  The block
  sums its gradient in the gathered leaves over the data group (the
  transpose of the all-gather) before each rank pulls its slice back;
- a named site whose data dims cut an event of its law: jaws' 80-long
  ``BDiagNormal`` event cut by boy, and line's v (6, 2) cut on its
  MvNormal's event dim.  The term is computed whole from the whole values
  of what it reads in part, and counts on data rank 0;
- a node gathered from a slice that reads another gathered node: the
  leaves are gathered once and the slices between computed whole;
- line's five points padded to six beside an array of six given as six:
  each node's padding is its own record, not inferred from a length; a
  slice whose padded entry does not move with y's (``y > 0``) and one of
  an integer array carry it too, so the counts read from them are the
  unsharded run's.

In one process, rank by rank (``_DataRank``, no collective called): each
layout's block density and gradient and its ``logpdf``, the ranks' parts
summed, against the port's whole model (1e-12) and the JAX package's
compiled density at the same state (1e-10; the fused GLMM as its own tests
run it on the CPU).  Across two gloo ranks (this file run as a script,
started once for the module by ``parallel.launch.run_ranks``): each
layout's run on the emulated card (tests/_torch_card.py) equal to its plain
loops bit for bit and to the unsharded port's run (1e-8), its
``logpdf_chains`` and DIC, and the per-call blocks' completed density and
gradient (their all-gather and two all-reduces) against the JAX package's.
Float64 throughout.  The rank processes import no JAX."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mamba_tpu_torch as tmt
from mamba_tpu_torch.model.mcmc import _pad_sharded
from mamba_tpu_torch.parallel.launch import run_ranks
from mamba_tpu_torch.parallel.mesh import MeshComm, make_mesh, pad_axes
from mamba_tpu_torch.utils import graphs

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_card import _emulate_the_card  # noqa: E402

torch.set_num_threads(2)

#: seconds the ranks may take, and a collective may wait
RANKS_TIMEOUT, GROUP_TIMEOUT = 240, 60
#: chains of the rank-by-rank states, of the runs, and the GLMM's size
C, RUN_CHAINS, G, N_OBS = 3, 2, 64, 4


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


def _xp(pkg):
    """The array module of a package's model lambdas."""
    if pkg is tmt:
        return torch
    import jax.numpy as jnp
    return jnp


# ---- the layouts: build(pkg) -> (model, inputs, init) --------------------
def _sum0(fused, g=G, w=True):
    """The GLMM with the sum-to-zero effect b = sqrt(s2) * (z - mean(z))
    and z ~ Normal(w, 1), w a per-group input: z's prior reads the rank's
    slice of w, so the rank holds z in part, b is gathered per call of the
    (beta, z, s2) block, which moves z, and y, named, reads its slice of
    it.  ``w=False``: z ~ Normal(0, 1)."""
    def build(pkg):
        xp = _xp(pkg)
        model, inputs, inits, _ = pkg.models.glmm.build(
            G=g, n=N_OBS, seed=2, fused=fused)
        nodes = {"b": pkg.Logical(
            1, lambda s2, z: xp.sqrt(s2) * (z - xp.mean(z)), monitor=False)}
        if w:
            nodes["z"] = pkg.Stochastic(1, lambda w: pkg.Normal(w, 1.0),
                                        monitor=False)
            inputs = dict(inputs, w=0.1 * np.random.default_rng(5).normal(
                size=g))
        model = pkg.Model(**{**model.nodes, **nodes})
        model.set_samplers([pkg.ChEESHMC(("beta", "z", "s2"), max_steps=8,
                                         mass_window=4)] if pkg is tmt
                           else [pkg.NUTS(["beta", "z", "s2"])])
        return model, inputs, inits[0]
    return build


def _six(pkg, extra, inits, samplers, y=(1.0, 3.0, 3.0, 3.0, 5.0, 6.0)):
    """line on six points, with ``extra(pkg)``'s nodes added, their inits
    and Slice samplers."""
    model, inputs, init = pkg.models.line.build()
    init = dict(init[0], y=np.array(y, dtype=float), **inits)
    inputs = dict(inputs, xmat=np.stack([np.ones(6), np.arange(1.0, 7.0)], 1),
                  w=np.linspace(-0.6, 0.9, 6))
    model = pkg.Model(**{**model.nodes, **extra(pkg)})
    model.set_samplers([pkg.NUTS("beta"), pkg.Slice("s2", 3.0)]
                       + [pkg.Slice(n, 1.0) for n in samplers])
    return model, inputs, init


def _named_reader(pkg):
    """y2, named, reads ss = sum((y - mu)**2), which beta's block gathers
    per call (and tau's prior reads, counted on data rank 0)."""
    xp = _xp(pkg)
    model, inputs, init = _six(pkg, lambda pkg: dict(
        ss=pkg.Logical(lambda y, mu: xp.sum((y - mu) ** 2), monitor=False),
        tau=pkg.Stochastic(lambda ss: pkg.Normal(0.1 * ss, 1.0)),
        y2=pkg.Stochastic(1, lambda mu, ss: pkg.Normal(mu + 0.01 * ss, 1.0),
                          monitor=False)), {"tau": 0.5}, ["tau"])
    return model, inputs, dict(init, y2=init["y"] + 0.5)


def _jaws(pkg):
    """jaws with y and x cut by boy: y is one 80-long BDiagNormal event."""
    model, inputs, inits = pkg.models.jaws.build()
    return model, inputs, inits[0]


def _jaws_mu(pkg):
    """jaws with its mean a logical node, mu = beta0 + beta1 * x, a slice:
    y's whole term reads mu's whole value, which the (beta0, beta1) block
    gathers per call."""
    xp = _xp(pkg)
    model, inputs, init = _jaws(pkg)
    n, m = pkg.models.jaws.N, pkg.models.jaws.M
    model = pkg.Model(**{
        **model.nodes,
        "mu": pkg.Logical(1, lambda beta0, beta1, x: beta0 + beta1 * x,
                          monitor=False),
        "y": pkg.Stochastic(1, lambda mu, Sigma: pkg.BDiagNormal(
            mu, xp.broadcast_to(Sigma, (n, m, m))), monitor=False)})
    model.set_samplers(_jaws(pkg)[0].samplers)
    return model, inputs, init


def _line_v(pkg):
    """v (6, 2) ~ MvNormal(stack([w, w]), I) per row, cut on its event."""
    xp = _xp(pkg)
    return _six(pkg, lambda pkg: dict(v=pkg.Stochastic(2, lambda w: pkg.MvNormal(
        xp.stack([w, w], 1), xp.eye(2, dtype=w.dtype)), monitor=False)),
        {"v": np.linspace(-1.0, 1.2, 12).reshape(6, 2)}, ["v"])


def _nested(pkg):
    """g2 = sum(h**2) read by tau's prior, where h = mu - g1 is a slice
    computed from g1 = mean(mu), itself gathered: a nested gather."""
    xp = _xp(pkg)
    return _six(pkg, lambda pkg: dict(
        g1=pkg.Logical(lambda mu: xp.mean(mu), monitor=False),
        h=pkg.Logical(1, lambda mu, g1: mu - g1, monitor=False),
        g2=pkg.Logical(lambda h: xp.sum(h ** 2), monitor=False),
        tau=pkg.Stochastic(lambda g2: pkg.Normal(0.1 * g2, 1.0))),
        {"tau": 0.5}, ["tau"])


def _padded_beside_given(pkg):
    """line's own five points, which a data axis of two pads to six, with
    tau's prior reading mean(y) and u ~ Normal(w, 1) beside them, w six
    entries as given: 6 is a padded length of y and a real one of w."""
    xp = _xp(pkg)
    model, inputs, inits = pkg.models.line.build()
    model = pkg.Model(**{
        **model.nodes,
        "ybar": pkg.Logical(lambda y: xp.mean(y), monitor=False),
        "tau": pkg.Stochastic(lambda ybar: pkg.Normal(ybar, 1.0)),
        "u": pkg.Stochastic(1, lambda w: pkg.Normal(w, 1.0), monitor=False)})
    model.set_samplers([pkg.NUTS("beta"), pkg.Slice("s2", 3.0),
                        pkg.Slice("tau", 1.0), pkg.Slice("u", 1.0)])
    return model, dict(inputs, w=np.linspace(-0.6, 0.9, 6)), dict(
        inits[0], tau=0.5, u=np.zeros(6))


def _padded_flat(pkg):
    """line's own five points, which a data axis of two pads to six, with
    tau's prior reading npos = sum(pos), pos = (y > 0) a slice that y's
    padded tail does not move, and non = sum(kind > 0) of an integer
    array of five, padded too."""
    xp = _xp(pkg)
    model, inputs, inits = pkg.models.line.build()
    model = pkg.Model(**{
        **model.nodes,
        "pos": pkg.Logical(1, lambda y: (y > 0) * xp.ones_like(y),
                           monitor=False),
        "on": pkg.Logical(1, lambda kind: kind > 0, monitor=False),
        "npos": pkg.Logical(lambda pos: xp.sum(pos), monitor=False),
        "non": pkg.Logical(lambda on: xp.sum(on), monitor=False),
        "tau": pkg.Stochastic(lambda npos, non: pkg.Normal(
            0.1 * npos + 0.25 * non, 1.0))})
    model.set_samplers([pkg.NUTS("beta"), pkg.Slice("s2", 3.0),
                        pkg.Slice("tau", 1.0)])
    return model, dict(inputs, kind=np.array([0, 1, 1, 0, 1])), dict(
        inits[0], tau=0.5)


LINE6_SPECS = {"y": ("data",), "xmat": ("data", None)}
#: name: (build, site_specs, the blocks held to the whole)
CASES = {
    "sum0_fused": (_sum0(True), {"y": (None, "data"),
                                 "xt": (None, None, "data"), "z": ("data",),
                                 "w": ("data",)},
                   [("beta", "z", "s2")]),
    "sum0_generic": (_sum0(False), {"y": ("data", None),
                                    "x": ("data", None, None), "z": ("data",),
                                    "w": ("data",)},
                     [("beta", "z", "s2")]),
    "named_reader": (_named_reader, {**LINE6_SPECS, "y2": ("data",)},
                     [("beta", "s2", "tau"), ("tau",)]),
    "jaws": (_jaws, {"y": ("data",), "x": ("data",)},
             [("beta0", "beta1"), ("Sigma",)]),
    "jaws_mu": (_jaws_mu, {"y": ("data",), "x": ("data",)},
                [("beta0", "beta1"), ("Sigma",)]),
    "line_v_event": (_line_v, {**LINE6_SPECS, "w": ("data",),
                               "v": (None, "data")},
                     [("beta", "s2", "v"), ("v",)]),
    "nested": (_nested, LINE6_SPECS, [("beta", "s2", "tau"), ("tau",)]),
    "padded_beside_given": (_padded_beside_given,
                            {**LINE6_SPECS, "w": ("data",), "u": ("data",)},
                            [("beta", "s2", "tau", "u")]),
    "padded_flat": (_padded_flat, {**LINE6_SPECS, "kind": ("data",)},
                    [("beta", "s2", "tau"), ("tau",)]),
}
#: the cases whose arrays a data axis of two pads
PADDED = {"padded_beside_given", "padded_flat"}


def _states(init, rng, chains=C):
    """``chains`` chains around ``init``: each continuous sampled site
    moved by a standard normal step (variances and covariances by a
    factor), data as it is."""
    out = {}
    for k, v in init.items():
        v = np.asarray(v, dtype=float)
        if k in ("y", "y2"):
            out[k] = np.broadcast_to(v, (chains,) + v.shape).copy()
        elif k.startswith("s2") or k == "Sigma":
            out[k] = v * rng.gamma(4.0, 0.25, size=(chains,) + (1,) * v.ndim)
        else:
            out[k] = v + rng.normal(size=(chains,) + v.shape)
    return out


def _port(case):
    """The port's unsharded model, each data rank's (on the arrays as a
    data axis of two pads them, for a padded case), the whole state as the
    ranks take it and as the unsharded model takes it, and the latter in
    numpy."""
    build, specs, _ = CASES[case]
    model, inputs, init = build(tmt)
    whole = tmt.compile_model(model, inputs, init, device="cpu")
    np_state = _states(init, np.random.default_rng(5))
    state = {k: torch.as_tensor(v) for k, v in np_state.items()}
    masks = pads = None
    p_state = state
    if case in PADDED:
        inputs, inits, masks, pads = _pad_sharded(
            model, {"chains": 1, "data": 2}, specs, inputs, [init])
        init = inits[0]
        p_state, _ = pad_axes({"chains": 1, "data": 2},
                              {k: (None,) + tuple(specs[k]) for k in specs
                               if k in state}, np_state)
        p_state = {k: torch.as_tensor(v) for k, v in p_state.items()}
    ranks = [tmt.compile_model(model, inputs, init, device="cpu", masks=masks,
                               comm=_DataRank(r), site_specs=specs, pads=pads)
             for r in (0, 1)]
    return whole, ranks, p_state, state, np_state


def _wholes(ranks, locals_, slices):
    """The gathered leaves' whole values from every rank's ``slices``
    (the all-gather, by hand), added to each rank's local state."""
    if not ranks[0]._gather_dims:
        return locals_
    wholes = ranks[0].join_wholes(slices)
    return [{**st, **wholes} for st in locals_]


def _rank_blocks(ranks, block, state, xs):
    """Each rank's block value and gradient at its flat vector ``xs[k]``,
    as ``block_density`` computes them with its collectives: a block that
    gathers per call evaluates its density on the leaves gathered from
    every rank's flat vector, sums the ranks' gradients in them, and adds
    its slice of that cotangent pulled back (``block_pull``)."""
    locals_ = [cm.cut_state(state) for cm in ranks]
    per_call = ranks[0].block_gathers(block) == "call"
    if not per_call:
        slices = [torch.func.vmap(cm._parent_values)(st)
                  for cm, st in zip(ranks, locals_)]
        out = []
        for cm, x, st in zip(ranks, xs, _wholes(ranks, locals_, slices)):
            logf = cm.block_functions(block, True)[3]
            g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, st)
            out.append((v, g))
        return out
    slices = [torch.func.vmap(cm.block_parents(block, True))(x, st)
              for cm, x, st in zip(ranks, xs, locals_)]
    wholes = ranks[0].join_wholes(slices)
    parts = []
    for cm, x, st in zip(ranks, xs, locals_):
        logf = cm.block_functions(block, True)[3]
        (gx, gw), v = torch.func.vmap(torch.func.grad_and_value(
            lambda x, s, w: logf(x, {**s, **w}), argnums=(0, 2)))(
            x, st, wholes)
        parts.append((v, gx, gw))
    total = {k: sum(p[2][k] for p in parts) for k in parts[0][2]}
    parts = [(v, gx, total) for v, gx, _ in parts]
    return [(v, gx + torch.func.vmap(cm.block_pull(block, True))(x, st, gw))
            for cm, x, st, (v, gx, gw) in zip(ranks, xs, locals_, parts)]


def _scattered(cm, block, v):
    """A rank's per-coordinate ``v (C, rank dim)`` added into the unsharded
    flat order (zero elsewhere): summed over the ranks, the parts of a
    gradient give the whole one."""
    coords = cm.block_coords(block)
    if coords.index is None:
        return v
    out = v.new_zeros(v.shape[0], coords.dim)
    return out.index_add_(1, coords.index, v)


def _jax_model(case):
    import mamba_tpu as jmt
    model, inputs, init = CASES[case][0](jmt)
    return jmt.compile_model(model, inputs, init)


BLOCKS = [(c, i) for c in CASES for i in range(len(CASES[c][2]))]


@pytest.mark.parametrize("case, i", BLOCKS)
def test_block_parts_sum_to_the_whole_and_to_the_reference(case, i):
    """Each rank's block density and gradient from its local state, the
    gradient in any gathered leaves pulled back to its coordinates, summed
    over the ranks where the block is split (else each rank's is the
    whole, and the same on both): the port's whole model's (1e-12) and the
    JAX package's compiled block density (1e-10)."""
    import jax
    whole, ranks, p_state, state, np_state = _port(case)
    block = CASES[case][2][i]
    pack, _, _, logf = whole.block_functions(block, True)
    x = torch.func.vmap(pack)(state)
    g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, state)
    xs = []
    for cm in ranks:
        coords = cm.block_coords(block)
        xr = x if coords.index is None else x[:, coords.index]
        if not set(block) & set(cm._part_sites):   # no join over the ranks
            np.testing.assert_array_equal(
                cm.block_maps(block, True)[0](cm.cut_state(p_state)), xr)
        xs.append(xr)
    parts = _rank_blocks(ranks, block, p_state, xs)
    if ranks[0].block_split(block):     # the parts sum over the ranks
        v_sum = parts[0][0] + parts[1][0]
        g_sum = sum(_scattered(cm, block, p[1])
                    for cm, p in zip(ranks, parts))
    else:                               # each rank computes the whole
        np.testing.assert_array_equal(parts[0][0], parts[1][0])
        np.testing.assert_array_equal(parts[0][1], parts[1][1])
        v_sum, g_sum = parts[0]
    scale = float(g.abs().max())
    np.testing.assert_allclose(v_sum, v, rtol=1e-12)
    np.testing.assert_allclose(g_sum, g, rtol=1e-12, atol=1e-12 * scale)
    jcm = _jax_model(case)
    jpack, _, _, jlogf = jcm.block_functions(block, True)
    jvg = jax.jit(jax.value_and_grad(jlogf))
    for c in range(C):
        jst = {k: np.asarray(a[c]) for k, a in np_state.items()}
        jv, jg = jvg(jpack(jst), jst)
        np.testing.assert_allclose(float(v_sum[c]), float(jv), rtol=1e-10)
        np.testing.assert_allclose(g_sum[c], np.asarray(jg), rtol=1e-10,
                                   atol=1e-10 * scale)


@pytest.mark.parametrize("case", list(CASES))
def test_logpdf_parts_sum_to_the_whole_and_to_the_reference(case):
    whole, ranks, p_state, state, np_state = _port(case)
    want = torch.func.vmap(whole.logpdf)(state)
    locals_ = [cm.cut_state(p_state) for cm in ranks]
    slices = [torch.func.vmap(cm._parent_values)(st)
              for cm, st in zip(ranks, locals_)]
    got = sum(torch.func.vmap(cm.logpdf_part)(st) for cm, st in
              zip(ranks, _wholes(ranks, locals_, slices)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    jcm = _jax_model(case)
    for c in range(C):
        jst = {k: np.asarray(a[c]) for k, a in np_state.items()}
        np.testing.assert_allclose(float(got[c]), float(jcm.logpdf(jst)),
                                   rtol=1e-10)


def test_how_each_layout_is_taken():
    """What each layout compiles to on a data rank: the sum-to-zero GLMM
    gathers z per call of its block, its y
    read as the rank's slice of the whole b; jaws' y and line's v are
    whole terms, jaws' from constants fixed at compile time and v from its
    whole value in the state (Slice cannot hold a slice, and its term is
    whole); the nested gather's leaves are mu alone, h computed whole on
    the way; and y's padding is y's own record, not w's length.  With z ~
    Normal(0, 1) the sum-to-zero effect reads only z's whole value, which
    the state then holds (a recut logical, as rats' alpha - mean(alpha)):
    no gather.  A slice of the padded y that y's padded tail does not move
    (``y > 0``) and one of an integer array carry their padding, and the
    counts read from them are the unsharded run's."""
    for case in ("sum0_fused", "sum0_generic"):
        _, ranks, _, _, _ = _port(case)
        for cm in ranks:
            assert cm._gathered == {"b": {"z": {0: ("data",)}}}
            assert "b" in cm.mixed
            assert cm._gather_dims == {"z": {0: ("data",)}}
            assert cm._cuts["y"] == {"b": {0: ("data",)}}
            assert cm._held == {"z": {0: ("data",)}}
            assert cm.block_gathers(("beta", "z", "s2")) == "call"
            assert cm._local_plans["y"][0] == "local"
    _, ranks, _, _, _ = _port("named_reader")
    assert ranks[1].block_gathers(("beta", "s2", "tau")) == "call"
    assert ranks[1].block_gathers(("tau",)) == "step"
    _, ranks, _, _, _ = _port("jaws")
    for cm in ranks:
        assert set(cm._whole_terms) == {"y"} and not cm._gather_dims
        assert set(cm._fixed_wholes) == {"y@whole", "x@whole"}
        assert cm.local_shape("y") == (40,) and cm.inputs["x"].shape == (40,)
        assert not cm.block_split(("beta0", "beta1"))
        assert cm.const_data == {"y"}
    _, ranks, _, _, _ = _port("jaws_mu")
    for cm in ranks:
        assert cm._whole_terms == {"y": {"mu": {0: ("data",)},
                                         "y": {0: ("data",)}}}
        assert cm._gather_dims == {"mu": {0: ("data",)}}
        assert set(cm._fixed_wholes) == {"y@whole"}
        assert cm.block_gathers(("beta0", "beta1")) == "call"
        assert cm.block_gathers(("Sigma",)) == "step"
    _, ranks, _, _, _ = _port("line_v_event")
    for cm in ranks:
        assert set(cm._whole_terms) == {"v"} and cm._state_wholes == {"v"}
        assert "cut an event of its MvNormal" in cm._whole_reasons["v"]
    _, ranks, _, _, _ = _port("nested")
    for cm in ranks:
        assert cm._gathered == {"g1": {"mu": {0: ("data",)}},
                                "g2": {"mu": {0: ("data",)}}}
        assert cm._paths == {"g2": ["h"]}
        assert cm.block_gathers(("beta", "s2", "tau")) == "call"
    _, ranks, _, _, _ = _port("padded_beside_given")
    for cm in ranks:
        assert cm._padded["y"] == {0: (5, 6)} and "w" not in cm._padded
        assert cm._padded["mu"] == {0: (5, 6)}
        np.testing.assert_allclose(cm._consts["ybar"][1], 3.0, rtol=1e-15)
    _, ranks, _, _, _ = _port("padded_flat")
    for cm in ranks:
        assert cm._padded["pos"] == cm._padded["on"] == {0: (5, 6)}
        assert float(cm._consts["npos"][1]) == 5.0
        assert int(cm._consts["non"][1]) == 3
    model, inputs, init = _sum0(True, w=False)(tmt)
    cm = tmt.compile_model(model, inputs, init, device="cpu",
                           comm=_DataRank(1),
                           site_specs=CASES["sum0_fused"][1])
    assert cm._recut == {"b": {0: ("data",)}} and not cm._gathered
    assert cm._whole_reasons == {
        "z": "a logical computed from its whole value reads it"}


def test_a_padded_slice_the_probe_cannot_evaluate_is_refused_by_name():
    """A slice of the padded y that cannot be evaluated with y's padded
    tail moved (its function refuses a 6, the moved tail) is refused by a
    ValueError that names it: its padding cannot be confirmed."""
    def doubled(y):
        if bool((y == 6.0).any()):
            raise ValueError("a six")
        return 2.0 * y

    model, inputs, init = _padded_flat(tmt)
    model = tmt.Model(**{**model.nodes,
                         "pos": tmt.Logical(1, doubled, monitor=False)})
    model.set_samplers(_padded_flat(tmt)[0].samplers)
    specs = CASES["padded_flat"][1]
    inputs, inits, masks, pads = _pad_sharded(
        model, {"chains": 1, "data": 2}, specs, inputs, [init])
    with pytest.raises(ValueError, match="node 'pos' is a slice of arrays "
                                         "the data axes pad, and it cannot"):
        tmt.compile_model(model, inputs, inits[0], device="cpu", masks=masks,
                          comm=_DataRank(0), site_specs=specs, pads=pads)


def test_a_whole_term_site_held_by_nuts_stays_whole_and_says_why():
    """v cut on its MvNormal's event under NUTS, which can hold slices:
    its term is computed whole, so v stays whole in the state, and
    ``_whole_reasons`` names the event."""
    model, inputs, init = _line_v(tmt)
    model.set_samplers([tmt.NUTS("beta"), tmt.Slice("s2", 3.0),
                        tmt.NUTS("v")])
    cm = tmt.compile_model(model, inputs, init, device="cpu",
                           comm=_DataRank(1),
                           site_specs=CASES["line_v_event"][1])
    assert "v" not in cm._held
    assert "cut an event of its MvNormal" in cm._whole_reasons["v"]


def test_the_fused_law_split_on_its_groups_stays_held_to_its_slices():
    """A law that splits its event on the data dim (the fused GLMM's
    groups, ``event_split_dim``) is not computed whole: its part is the
    rank's groups, and a rolled b that no cut confirms stays refused."""
    _, ranks, _, _, _ = _port("sum0_fused")
    assert not ranks[0]._whole_terms
    from mamba_tpu_torch.ops.fused_glmm import BernoulliLogitGLMM
    model, inputs, init = _sum0(True)(tmt)
    model = tmt.Model(**{**model.nodes, "y": tmt.Stochastic(
        2, lambda xt, beta, b: BernoulliLogitGLMM(xt, beta, torch.roll(b, 1)),
        monitor=False)})
    model.set_samplers(_sum0(True)(tmt)[0].samplers)
    with pytest.raises(ValueError, match="the density of 'y' cannot be"):
        tmt.compile_model(model, inputs, init, device="cpu",
                          comm=_DataRank(0),
                          site_specs={"y": (None, "data"),
                                      "xt": (None, None, "data")})


# ---- across two gloo ranks ----------------------------------------------
#: the runs: (iterations, burnin); the GLMM at a width its ChEES run takes
#: fast on the CPU
RUNS = {"sum0_fused": (8, 4), "named_reader": (10, 5), "jaws": (8, 4),
        "jaws_mu": (8, 4),
        "line_v_event": (10, 5), "nested": (10, 5),
        "padded_beside_given": (10, 5)}
#: the blocks whose completed density the ranks compute with their
#: collectives (``block_density``)
DENSITY = {"sum0_fused": ("beta", "z", "s2"),
           "named_reader": ("beta", "s2", "tau")}
RUN_G = 16


def _arm(name):
    """An arm's (model, inputs, init) as ``mcmc`` takes it, every sampled
    node monitored (``logpdf_chains`` and DIC read their draws): the
    padded case as given (``mcmc`` pads it)."""
    import dataclasses
    build = _sum0(True, RUN_G) if name == "sum0_fused" else CASES[name][0]
    model, inputs, init = build(tmt)
    for n in model.keys("stochastic"):
        if n not in model.keys("observed"):
            model.nodes[n] = dataclasses.replace(model.nodes[n], monitor=True)
    return model, inputs, init


def _run(name, mesh=None, plain=False):
    model, inputs, init = _arm(name)
    iters, burnin = RUNS[name]
    kw = dict(burnin=burnin, chains=RUN_CHAINS, seed=7, device="cpu",
              verbose=False)
    if mesh is not None:
        kw.update(mesh=mesh, site_specs=CASES[name][1])
    if plain:
        with graphs.disabled():
            return tmt.mcmc(model, inputs, [init], iters, **kw)
    return tmt.mcmc(model, inputs, [init], iters, **kw)


def _result(sim) -> dict:
    return {"value": sim.value, "logpdf": tmt.logpdf_chains(sim).value,
            "dic": np.asarray(tmt.dic(sim).value),
            "predict": tmt.predict(sim, seed=1).value}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one launch of two ranks."""
    tmp = tmp_path_factory.mktemp("gathered_terms")
    env = dict(os.environ, MULTIPROC_OUT=str(tmp))
    run_ranks(lambda r, init: [sys.executable, __file__, init, 2, r], 2,
              timeout=RANKS_TIMEOUT, env=env)
    return [dict(np.load(tmp / f"ranks{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def unsharded():
    return {name: _result(_run(name)) for name in RUNS}


@pytest.mark.parametrize("arm", list(RUNS))
def test_a_run_on_two_data_ranks_is_the_unsharded_run(ranks, unsharded, arm):
    """The run on the emulated card took its captured steps, cut at the
    collectives, and equals its plain loops bit for bit on each rank; its
    draws, ``logpdf_chains``, DIC and ``predict`` (the observed sites drawn
    whole and gathered; jaws' y from its whole term) equal the unsharded
    port's run (1e-8), the same on both ranks."""
    ref = unsharded[arm]
    for r in ranks:
        graphs_, replays, collectives = r[f"{arm}:counts"]
        assert graphs_ > 0 and replays >= graphs_, arm
        for k in ref:
            np.testing.assert_array_equal(r[f"{arm}:card_{k}"],
                                          r[f"{arm}:plain_{k}"], err_msg=k)
            np.testing.assert_allclose(r[f"{arm}:card_{k}"], ref[k],
                                       rtol=1e-8, atol=1e-10, err_msg=k)
        np.testing.assert_array_equal(r[f"{arm}:card_value"],
                                      ranks[0][f"{arm}:card_value"])
        assert np.isfinite(r[f"{arm}:card_value"]).all()


def test_the_sum_to_zero_block_replays_with_its_two_added_cuts(ranks):
    """The sum-to-zero GLMM's ChEES leapfrog replays in segments cut at
    the all-gather of z, the all-reduce of the gradient in it and the
    density's all-reduce: three collectives per gradient."""
    for r in ranks:
        assert json.loads(str(r["sum0_fused:cuts"])) == [
            "all_gather", "all_reduce", "all_reduce"]
        assert r["sum0_fused:counts"][2] > 0


@pytest.mark.parametrize("arm", list(DENSITY))
def test_the_completed_density_matches_the_jax_package(ranks, arm):
    """The per-call block's density and gradient completed over the two
    ranks (all-gather, the gradient in the leaves summed, the rank's slice
    pulled back, all-reduce) against the JAX package's unsharded compiled
    block density, at each rank's coordinates (1e-10)."""
    import jax
    import mamba_tpu as jmt
    block = DENSITY[arm]
    build = _sum0(True, RUN_G) if arm == "sum0_fused" else CASES[arm][0]
    model, inputs, init = build(jmt)
    jcm = jmt.compile_model(model, inputs, init)
    jpack, _, _, jlogf = jcm.block_functions(block, True)
    jvg = jax.jit(jax.value_and_grad(jlogf))
    np_state = _states(init, np.random.default_rng(5), RUN_CHAINS)
    want_v, want_g = [], []
    for c in range(RUN_CHAINS):
        jst = {k: np.asarray(a[c]) for k, a in np_state.items()}
        jv, jg = jvg(jpack(jst), jst)
        want_v.append(float(jv))
        want_g.append(np.asarray(jg))
    want_g = np.stack(want_g)
    scale = np.abs(want_g).max()
    for r in ranks:
        np.testing.assert_allclose(r[f"{arm}:v"], want_v, rtol=1e-10)
        np.testing.assert_allclose(r[f"{arm}:g"], want_g[:, r[f"{arm}:index"]],
                                   rtol=1e-10, atol=1e-10 * scale)


# ---- the ranks ----------------------------------------------------------
def _rank_density(name, mesh):
    """The per-call block's completed density and gradient on this rank,
    inside an emulated capture: its values and its cuts."""
    block = DENSITY[name]
    specs = CASES[name][1]
    model, inputs, init = _arm(name)
    cm = tmt.compile_model(model, inputs, init, device="cpu",
                           comm=MeshComm(mesh), site_specs=specs)
    np_state = _states(init, np.random.default_rng(5), RUN_CHAINS)
    state = cm.cut_state({k: torch.as_tensor(v) for k, v in np_state.items()})
    state = cm.block_prepare(block)(state)
    x = cm.block_maps(block, True)[0](state)
    density = cm.block_density(block, True, grad=True)

    def body(b, s):
        v, g = density(b["x"], s)
        b["v"].copy_(v)
        b["g"].copy_(g)
    cap = graphs.Captured(body)
    cap.load(x=x, v=torch.zeros(RUN_CHAINS, dtype=x.dtype),
             g=torch.zeros_like(x))
    cap.load_state(state)
    cap.run(2)
    coords = cm.block_coords(block)
    return {"v": cap.bufs["v"].numpy(), "g": cap.bufs["g"].numpy(),
            "index": (np.arange(x.shape[1]) if coords.index is None
                      else coords.index.numpy()),
            "cuts": json.dumps([c.kind for c in cap.graphs["body"].cuts])}


def _rank_all(rank):
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    out = {}
    for name in RUNS:
        with pytest.MonkeyPatch.context() as mp:
            _emulate_the_card(mp)
            if name in DENSITY:
                out.update({f"{name}:{k}": v for k, v in
                            _rank_density(name, mesh).items()})
            before = dict(graphs.STATS)
            card = _run(name, mesh)
            out[f"{name}:counts"] = np.array(
                [graphs.STATS[k] - before[k]
                 for k in ("graphs", "replays", "collectives")])
        plain = _run(name, mesh, plain=True)
        for tag, sim in (("card", card), ("plain", plain)):
            out.update({f"{name}:{tag}_{k}": v
                        for k, v in _result(sim).items()})
    return out


def _main(argv) -> int:
    from mamba_tpu_torch.parallel import distributed_init
    init, n, rank = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    distributed_init(init, n, rank, device_type="cpu", timeout=GROUP_TIMEOUT)
    try:
        out = _rank_all(rank)
        np.savez(Path(os.environ["MULTIPROC_OUT"]) / f"ranks{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
