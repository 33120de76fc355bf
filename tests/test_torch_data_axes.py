"""Several data axes, as the JAX package's PartitionSpecs name them: a mesh
of the chain axis and two data axes, a spec entry of one axis or a tuple
of axes, a dim cut by the product of its axes' sizes (its first axis
major), and a value cut over some data axes replicated over the others,
counted once.

1. ``DataGroup.block`` against the shards that ``jax.device_put`` puts on
   the 8 host devices (tests/conftest.py) under the same ``NamedSharding``,
   and ``pad_axes`` against the JAX package's;
2. four gloo ranks of a (1, 2, 2) mesh (this file run as a script, started
   by ``parallel.launch.run_ranks`` once for the module), float64, in three
   layouts: rats cut by rat and by week (``y: ("data", "week")``, ``Xm:
   ("week",)``, ``alpha``, ``beta: ("data",)``, the five weeks padded to
   six), the fused GLMM's groups over a tuple of axes (``y: (None,
   ("data", "obs"))``) and the generic GLMM cut on two dims (``y:
   ("data", "obs")``, ``z: ("data",)``); and two blocks that gather per
   density call a leaf cut on ``data`` alone, replicated over ``obs`` (so
   one of the two ranks that hold a slice alike pulls it back): line's ss
   = sum((y - mu)**2), read by tau's prior and by y2, named, and the
   sum-to-zero GLMM's b = sqrt(s2) * (z - mean(z)) with z on ``data``
   (tests/test_torch_gathered_terms.py).  For each: the completed block
   density and gradient against the JAX package's unsharded ones, the
   ranks' ``logpdf`` parts against its ``logpdf``, a run on the emulated
   card (tests/_torch_card.py) equal to its plain loops bit for bit and
   to the unsharded port's run (1e-8), its file restarted on one device,
   ``forward_sample``'s blocks and DIC;
3. the JAX package's own rats run on such a layout, and the refusals that
   stay.

The rank processes import no JAX."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mamba_tpu_torch as tmt
from mamba_tpu_torch.model import mcmc as tmcmc
from mamba_tpu_torch.models import glmm as tglmm
from mamba_tpu_torch.ops import random as R
from mamba_tpu_torch.parallel.launch import run_ranks
from mamba_tpu_torch.parallel.mesh import (DataGroup, MeshComm, data_dim,
                                           make_mesh, pad_axes)
from mamba_tpu_torch.utils import graphs

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_card import _emulate_the_card  # noqa: E402
from test_torch_gathered_terms import _named_reader, _sum0  # noqa: E402

torch.set_num_threads(2)

#: seconds the ranks may take, and a collective may wait
RANKS_TIMEOUT, GROUP_TIMEOUT = 240, 60
#: chains, and the iterations of a restart
C, MORE = 2, 3
#: each arm's run (iterations, burnin): rats's NUTS trees are deep enough
#: at its start that its run is cut to keep the module within its time
RUNS = {"rats": (8, 4), "glmm_fused": (20, 10), "glmm_generic": (20, 10),
        "line_ss": (10, 5), "glmm_sum0": (10, 5)}
RATS_BLOCK = ("alpha", "beta", "mu_alpha", "mu_beta")
GLMM_BLOCK = ("beta", "z", "s2")
G = 16


def _rats(pkg):
    """rats under NUTS, every sampled node monitored but y (padded)."""
    import dataclasses
    model, inputs, inits = pkg.models.rats.build("nuts")
    for n in model.keys("stochastic"):
        if n != "y":
            model.nodes[n] = dataclasses.replace(model.nodes[n], monitor=True)
    return model, inputs, inits[0]


def _glmm(pkg, fused):
    import dataclasses
    model, inputs, inits, _ = pkg.models.glmm.build(
        G=G, n=5 if fused else 6, seed=3, fused=fused)
    model.nodes["z"] = dataclasses.replace(model.nodes["z"], monitor=True)
    if pkg is tmt:
        model.set_samplers([tmt.ChEESHMC(GLMM_BLOCK, max_steps=8,
                                         mass_window=4)])
    return model, inputs, inits[0]


def _monitored(build):
    """``build`` with every sampled node monitored (DIC reads them)."""
    def monitored(pkg):
        import dataclasses
        model, inputs, init = build(pkg)
        for n in model.keys("stochastic"):
            if n not in model.keys("observed"):
                model.nodes[n] = dataclasses.replace(model.nodes[n],
                                                     monitor=True)
        return model, inputs, init
    return monitored


#: name: (build, the second data axis, site_specs, block, the site drawn
#: by ``forward_sample``)
ARMS = {
    "rats": (_rats, "week", {"y": ("data", "week"), "Xm": ("week",),
                             "alpha": ("data",), "beta": ("data",)},
             RATS_BLOCK, "y"),
    "glmm_fused": (lambda pkg: _glmm(pkg, True), "obs",
                   {"y": (None, ("data", "obs")),
                    "xt": (None, None, ("data", "obs")),
                    "z": (("data", "obs"),)}, GLMM_BLOCK, "z"),
    "glmm_generic": (lambda pkg: _glmm(pkg, False), "obs",
                     {"y": ("data", "obs"), "x": ("data", "obs", None),
                      "z": ("data",)}, GLMM_BLOCK, "y"),
    "line_ss": (_monitored(_named_reader), "obs",
                {"y": ("data",), "xmat": ("data", None), "y2": ("data",)},
                ("beta", "s2", "tau"), "y2"),
    "glmm_sum0": (_monitored(_sum0(True, G)), "obs",
                  {"y": (None, "data"), "xt": (None, None, "data"),
                   "z": ("data",), "w": ("data",)}, GLMM_BLOCK, "y"),
}


def _states(init):
    """C chains around ``init``: each sampled site moved by a standard
    normal step (variances by a factor), the data as they are."""
    rng = np.random.default_rng(5)
    out = {}
    for k, v in init.items():
        v = np.asarray(v, dtype=float)
        if k in ("y", "y2"):
            out[k] = np.broadcast_to(v, (C,) + v.shape).copy()
        elif k.startswith("s2"):
            out[k] = v * rng.gamma(4.0, 0.25, size=(C,) + (1,) * v.ndim)
        else:
            out[k] = v + rng.normal(size=(C,) + v.shape)
    return out


def _flat_tunes(tunes) -> np.ndarray:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x.reshape(-1).double())
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, (int, float)):
            out.append(torch.tensor([x], dtype=torch.float64))
    walk(tunes)
    return torch.cat(out).numpy() if out else np.zeros(0)


def _run(name, mesh=None, plain=False):
    build, _, specs, _, _ = ARMS[name]
    model, inputs, init = build(tmt)
    iters, burnin = RUNS[name]
    kw = dict(burnin=burnin, chains=C, seed=7, device="cpu", verbose=False)
    if mesh is not None:
        kw.update(mesh=mesh, site_specs=specs)
    if plain:
        with graphs.disabled():
            return tmt.mcmc(model, inputs, [init], iters, **kw)
    return tmt.mcmc(model, inputs, [init], iters, **kw)


def _result(sim, whole=None) -> dict:
    """A run's draws, tunes and final state as one device holds them
    (``whole``: the rank's resume state gathered), and its DIC."""
    st = whole or sim.states
    return {"value": sim.value, "tunes": _flat_tunes(st["tunes"]),
            "dic": np.asarray(tmt.dic(sim).value),
            **{f"state_{k}": v.numpy() for k, v in st["state"].items()}}


# ---------------------------------------------------------------------------
# 1. the blocks and the padding against the JAX package's
# ---------------------------------------------------------------------------

#: (mesh, spec): a tuple entry, two cut dims, a tuple with its axes out of
#: mesh order, and a dim left whole
LAYOUTS = [
    ({"chains": 2, "data": 2, "week": 2}, ("data", "week")),
    ({"chains": 2, "data": 2, "week": 2}, (("data", "week"), None)),
    ({"chains": 2, "data": 2, "week": 2}, (None, ("week", "data"))),
    ({"chains": 1, "data": 2, "week": 3}, ("week", "data")),
    ({"chains": 1, "data": 2, "week": 3}, (("data", "week"), None)),
    ({"chains": 1, "data": 2, "week": 3}, (None, "week")),
]


@pytest.mark.parametrize("axes, spec", LAYOUTS)
def test_a_rank_s_block_is_the_shard_named_sharding_puts_there(axes, spec):
    """Each rank's ``DataGroup.block`` of a (12, 12) array under the
    layout ``data_dim`` reads from the spec equals the shard that
    ``jax.device_put(x, NamedSharding(mesh, spec))`` puts on the device at
    the same mesh coordinates."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    names, shape = tuple(axes), tuple(axes.values())
    devices = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    x = np.arange(144.0).reshape(12, 12)
    arr = jax.device_put(x, NamedSharding(Mesh(devices, names), P(*spec)))
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    geo = DataGroup(names[1:], shape[1:])
    layout = geo.layout(data_dim(spec, names[1:]))
    for at in np.ndindex(*shape):
        k = int(np.ravel_multi_index(at[1:], shape[1:]))
        np.testing.assert_array_equal(geo.block(x, layout, k),
                                      shards[devices[at]], err_msg=str(at))
    # the blocks of the ranks that count them assemble the whole
    over = geo.axes_of(layout)
    parts = [torch.as_tensor(geo.block(x, layout, k)) for k in range(geo.size)
             if geo.leads(over, k)]
    np.testing.assert_array_equal(
        geo.assemble(torch.stack(parts), layout).numpy(), x)


@pytest.mark.parametrize("axes, spec", LAYOUTS)
def test_pad_axes_pads_each_dim_as_the_jax_package_does(axes, spec):
    from mamba_tpu.parallel import mesh as jmesh
    import jax
    names, shape = tuple(axes), tuple(axes.values())
    devices = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    from jax.sharding import Mesh
    arrays = {"y": np.arange(35.0).reshape(5, 7)}
    want, want_pads = jmesh.pad_axes(Mesh(devices, names), {"y": spec},
                                     arrays)
    got, pads = pad_axes(axes, {"y": spec}, arrays)
    np.testing.assert_array_equal(got["y"], want["y"])
    assert pads == want_pads


def test_the_refusals_that_stay_name_the_axis():
    """An axis named on two dims, and the chain axis in a spec, raise
    ValueErrors that name them, in ``data_dim`` and through ``mcmc``."""
    with pytest.raises(ValueError, match="data axis 'week' on more than one"):
        data_dim(("week", ("data", "week")), ("data", "week"))
    with pytest.raises(ValueError, match="names the chain axis 'chains'"):
        data_dim((("data", "chains"),), ("data", "week"))
    model, inputs, init = _rats(tmt)
    mesh = make_mesh({"chains": 1, "data": 1, "week": 1}, "cpu")
    for spec, message in ((("data", "data"), "data axis 'data' on more"),
                          (("chains", None), "names the chain axis")):
        with pytest.raises(ValueError, match=message):
            tmt.mcmc(model, inputs, [init], 2, chains=1, device="cpu",
                     verbose=False, mesh=mesh, site_specs={"y": spec})


class _Rank:
    """Rank ``r`` of a (1, 2, 2) chains x data x obs mesh, for evaluating
    each part of a split density in one process (no collectives are
    called)."""
    chain_axis, data_axes, data_shape = "chains", ("data", "obs"), (2, 2)
    chain_rank, chain_size, data_size = 0, 1, 4

    def __init__(self, r):
        self.data_rank = r


def test_the_fused_glmm_cut_on_its_observations_is_taken():
    """The fused GLMM with y (n, G) cut by observations and by groups
    (``y: ("obs", "data")``): its law's event is cut on both dims, and each
    rank's law reads its block of xt and b, so its part is its block's own
    likelihood; the four ranks' ``logpdf`` parts sum to the JAX package's
    ``logpdf`` (1e-10), z held by rat and replicated over obs."""
    import mamba_tpu as jmt
    specs = {"y": ("obs", "data"), "xt": (None, "obs", "data"),
             "z": ("data",)}
    model, inputs, inits, _ = tglmm.build(G=G, n=6, seed=3, fused=True)
    jmodel, jinputs, jinits, _ = jmt.models.glmm.build(G=G, n=6, seed=3,
                                                        fused=True)
    np_state = _states(inits[0])
    jcm = jmt.compile_model(jmodel, jinputs, jinits[0])
    want = [float(jcm.logpdf({k: np.asarray(a[c]) for k, a in
                              np_state.items()})) for c in range(C)]
    state = {k: torch.as_tensor(v) for k, v in np_state.items()}
    parts = []
    for k in range(4):
        cm = tmt.compile_model(model, inputs, inits[0], device="cpu",
                               comm=_Rank(k), site_specs=specs)
        assert cm._local_plans["y"][0] == "local"
        assert cm._held == {"z": {0: ("data",)}}
        parts.append(torch.func.vmap(cm.logpdf_part)(cm.cut_state(state)))
    np.testing.assert_allclose(sum(parts).numpy(), want, rtol=1e-10)


def test_the_jax_package_runs_rats_on_two_data_axes():
    """The layout is one the reference takes: the JAX package's rats NUTS
    on {"chains": 2, "data": 2, "week": 2} over the 8 host devices, the
    weeks padded 5 -> 6, gives finite draws."""
    import jax
    import mamba_tpu as jmt
    from mamba_tpu.parallel import make_mesh as jmake_mesh
    model, inputs, init = _rats(jmt)
    mesh = jmake_mesh({"chains": 2, "data": 2, "week": 2},
                      jax.devices()[:8])
    sim = jmt.mcmc(model, inputs, [init], 8, burnin=4, chains=2, verbose=False,
                   mesh=mesh, site_specs=ARMS["rats"][2])
    assert np.isfinite(np.asarray(sim.value)).all()


# ---------------------------------------------------------------------------
# 2. four gloo ranks against the JAX package and the unsharded port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one launch of four ranks."""
    tmp = tmp_path_factory.mktemp("data_axes")
    env = dict(os.environ, MULTIPROC_OUT=str(tmp))
    run_ranks(lambda r, init: [sys.executable, __file__, init, 4, r], 4,
              timeout=RANKS_TIMEOUT, env=env)
    return tmp, [dict(np.load(tmp / f"ranks{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded port's run of every arm."""
    return {name: _run(name) for name in ARMS}


@pytest.mark.parametrize("arm", list(ARMS))
def test_the_completed_density_matches_the_jax_package(ranks, arm):
    """Each rank's block density and gradient, completed over the group
    (one all-reduce over the data group, and one over the axes a held
    site is replicated on: rats' alpha and beta over week, the generic
    GLMM's z over obs), against the JAX package's unsharded compiled
    block density at the same states, at the rank's coordinates (1e-10);
    and the ranks' ``logpdf`` parts sum to its ``logpdf``."""
    import jax
    import mamba_tpu as jmt
    build, _, _, block, _ = ARMS[arm]
    model, inputs, init = build(jmt)
    np_state = _states(init)
    jcm = jmt.compile_model(model, inputs, init)
    jpack, _, _, jlogf = jcm.block_functions(block, True)
    want_v, want_g, want_lp = [], [], []
    for c in range(C):
        jst = {k: np.asarray(a[c]) for k, a in np_state.items()}
        jv, jg = jax.value_and_grad(jlogf)(jpack(jst), jst)
        want_v.append(float(jv))
        want_g.append(np.asarray(jg))
        want_lp.append(float(jcm.logpdf(jst)))
    want_g = np.stack(want_g)
    scale = np.abs(want_g).max()
    _, res = ranks
    for r in res:
        np.testing.assert_allclose(r[f"{arm}:v"], want_v, rtol=1e-10)
        np.testing.assert_allclose(r[f"{arm}:g"], want_g[:, r[f"{arm}:index"]],
                                   rtol=1e-10, atol=1e-10 * scale)
    np.testing.assert_allclose(sum(r[f"{arm}:logpdf_part"] for r in res),
                               want_lp, rtol=1e-10)
    held = json.loads(str(res[0][f"{arm}:held"]))
    assert held == {"rats": {"alpha": {"0": ["data"]}, "beta": {"0": ["data"]}},
                    "glmm_fused": {"z": {"0": ["data", "obs"]}},
                    "glmm_generic": {"z": {"0": ["data"]}},
                    "line_ss": {}, "glmm_sum0": {"z": {"0": ["data"]}}}[arm]


@pytest.mark.parametrize("arm", list(ARMS))
def test_a_run_on_two_data_axes_is_the_unsharded_run(ranks, unsharded, arm):
    """The run on the emulated card took its captured steps and equals its
    plain loops bit for bit on every rank; the draws, tunes, final state
    (gathered whole, padding dropped) and DIC equal the unsharded port's
    run (1e-8), the same on every rank."""
    _, res = ranks
    ref = _result(unsharded[arm])
    for r in res:
        graphs_, replays, collectives = r[f"{arm}:counts"]
        assert graphs_ > 0 and replays >= graphs_ and collectives > 0
        for k in ref:
            np.testing.assert_array_equal(r[f"{arm}:card_{k}"],
                                          r[f"{arm}:plain_{k}"], err_msg=k)
            np.testing.assert_allclose(r[f"{arm}:card_{k}"], ref[k],
                                       rtol=1e-8, atol=1e-10, err_msg=k)
        np.testing.assert_array_equal(r[f"{arm}:card_value"],
                                      res[0][f"{arm}:card_value"])


@pytest.mark.parametrize("arm", list(ARMS))
def test_the_file_restarts_on_one_device(ranks, unsharded, arm):
    """The run's one chain file, read on one device, continues as the
    unsharded run does (1e-8)."""
    from mamba_tpu_torch.output import fileio
    tmp, _ = ranks
    model, inputs, _ = ARMS[arm][0](tmt)
    mc = fileio.read_chains(str(tmp / f"{arm}.pkl"), model, inputs,
                            device="cpu")
    assert not mc.compiled.comm.sharded
    more = tmt.mcmc(mc, MORE, verbose=False)
    want = tmt.mcmc(unsharded[arm], MORE, verbose=False)
    np.testing.assert_allclose(more.value, want.value, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("arm", list(ARMS))
def test_forward_sample_keeps_the_rank_s_block_of_the_whole_draw(ranks, arm):
    """A site drawn on a rank (rats' y, cut by rat and by week and padded;
    the fused GLMM's z over the tuple; the generic GLMM's y on two dims)
    is the rank's block of the draw without a mesh, at the padded
    shape."""
    build, axis, specs, _, name = ARMS[arm]
    model, inputs, init = build(tmt)
    sizes = {"chains": 1, "data": 2, axis: 2}
    p_inputs, p_inits, masks, given = tmcmc._pad_sharded(
        model, sizes, specs, inputs, [init])
    cm = tmt.compile_model(model, p_inputs, p_inits[0], device="cpu",
                           masks=masks)
    np_state = _states(init)
    for k, v in np_state.items():
        for d, length in given.get(k, {}).items():
            pad = [(0, 0)] * v.ndim
            pad[d + 1] = (0, p_inits[0][k].shape[d] - length)
            np_state[k] = np.pad(v, pad, mode="edge")
    whole = cm.forward_sample(R.chain_keys(3, range(C)),
                              {k: torch.as_tensor(v)
                               for k, v in np_state.items()}, names=(name,))
    geo = DataGroup(("data", axis), (2, 2))
    layout = geo.layout(data_dim(specs[name], ("data", axis)))
    _, res = ranks
    for k, r in enumerate(res):
        np.testing.assert_array_equal(
            r[f"{arm}:forward"], geo.block(whole[name], layout, k, lead=1))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_arm(name, rank, out_dir):
    from mamba_tpu_torch.output import fileio
    build, axis, specs, block, drawn = ARMS[name]
    mesh = make_mesh({"chains": 1, "data": 2, axis: 2}, "cpu")
    comm = MeshComm(mesh)
    model, inputs, init = build(tmt)
    p_inputs, p_inits, masks, given = tmcmc._pad_sharded(
        model, mesh, specs, inputs, [init])
    cm = tmt.compile_model(model, p_inputs, p_inits[0], device="cpu",
                           masks=masks, comm=comm, site_specs=specs,
                           pads=given)
    # the chain-stacked states, padded as the run pads the example
    np_state = _states(init)
    for k, v in np_state.items():
        for d, length in given.get(k, {}).items():
            pad = [(0, 0)] * v.ndim
            pad[d + 1] = (0, p_inits[0][k].shape[d] - length)
            np_state[k] = np.pad(v, pad, mode="edge")
    state = cm.cut_state({k: torch.as_tensor(v) for k, v in np_state.items()})
    out = {}
    # the completed block density and gradient, and the logpdf parts
    st = cm.block_prepare(block)(state)
    v, g = cm.block_density(block, True, grad=True)(
        cm.block_maps(block, True)[0](st), st)
    coords = cm.block_coords(block)
    out["v"], out["g"] = v.numpy(), g.numpy()
    out["index"] = (np.arange(g.shape[1]) if coords.index is None
                    else coords.index.numpy())
    out["held"] = json.dumps({k: {str(d): list(a) for d, a in l.items()}
                              for k, l in cm._held.items()})
    out["logpdf_part"] = torch.func.vmap(cm.logpdf_part)(
        cm.with_wholes(state)).numpy()
    # forward_sample keeps the rank's block of the whole draw
    keys = R.chain_keys(3, range(C))
    out["forward"] = cm.forward_sample(keys, state, names=(drawn,))[
        drawn].numpy()
    # a run on the emulated card, the plain loops, and the file
    with pytest.MonkeyPatch.context() as mp:
        _emulate_the_card(mp)
        before = dict(graphs.STATS)
        card = _run(name, mesh)
        out["counts"] = np.array([graphs.STATS[k] - before[k] for k in
                                  ("graphs", "replays", "collectives")])
    plain = _run(name, mesh, plain=True)
    fileio.write_chains(str(Path(out_dir) / f"{name}.pkl"), card)
    for tag, sim in (("card", card), ("plain", plain)):
        out.update({f"{tag}_{k}": v for k, v in
                    _result(sim, fileio._whole_states(sim)).items()})
    out["shape_y"] = np.array(card.states["state"]["y"].shape)
    return {f"{name}:{k}": v for k, v in out.items()}


def _main(argv) -> int:
    from mamba_tpu_torch.parallel import distributed_init
    init, n, rank = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    distributed_init(init, n, rank, device_type="cpu", timeout=GROUP_TIMEOUT)
    out_dir = os.environ["MULTIPROC_OUT"]
    try:
        out = {}
        for name in ARMS:
            out.update(_rank_arm(name, rank, out_dir))
        np.savez(Path(out_dir) / f"ranks{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
