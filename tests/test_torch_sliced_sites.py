"""Named sampled sites held as slices on a mesh's data axis, as GSPMD
shards them (mamba_tpu/model/mcmc.py:347-460): a NUTS, ChEES-HMC or
unit-mass HMC or MALA block holds each sampled site that ``site_specs``
names on the data axis as the rank's slice, in the state and in its flat
vector, momentum, gradient and per-coordinate tunes, and sums over its
coordinates across the data group (``parallel.mesh.BlockCoords``).

In one process, rank by rank (``_DataRank``: no collective is called):
each rank's parts of a block call (the value, the whole coordinates'
gradient summed over the ranks, its slice coordinates' gradient) against
the JAX package's block density and gradient at the same state (1e-10),
and which sites stay whole.  Across two gloo ranks (this file run as a
script, started by ``parallel.launch.run_ranks``): rats under NUTS and the
G = 64 GLMM under ChEES, HMC and MALA against the unsharded port runs
(draws, tunes and final state, 1e-8), each density call's all-reduce
counted, the runs whose sites stay whole, and a sharded chain file of the
rats run restarted on one device.  Float64 throughout; the rank processes
import no JAX."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mamba_tpu_torch as tmt
from mamba_tpu_torch.models import glmm as tglmm, rats as trats
from mamba_tpu_torch.parallel.launch import run_ranks
from mamba_tpu_torch.parallel.mesh import MeshComm, make_mesh

torch.set_num_threads(2)

#: seconds a two-rank test may take, and a collective may wait
RANKS_TIMEOUT, GROUP_TIMEOUT = 150, 60
RATS_SPECS = {"y": ("data",), "alpha": ("data",), "beta": ("data",)}
GLMM_LOCAL = {"y": (None, "data"), "xt": (None, None, "data"), "z": ("data",)}
GLMM_GENERIC = {"y": ("data", None), "x": ("data", None, None), "z": ("data",)}
G, C = 64, 3
GLMM_BLOCK = ("beta", "z", "s2")
RATS_BLOCK = ("alpha", "beta", "mu_alpha", "mu_beta")


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


def _rats(pkg):
    model, inputs, inits = pkg.models.rats.build("nuts")
    return model, inputs, inits[0]


def _glmm(fused):
    def build(pkg):
        model, inputs, inits, _ = pkg.models.glmm.build(G=G, n=10, seed=2,
                                                        fused=fused)
        return model, inputs, inits[0]
    return build


#: name: (build, site_specs, block, {held site: its slice's shape})
CASES = {"rats": (_rats, RATS_SPECS, RATS_BLOCK, {"alpha": (15,), "beta": (15,)}),
         "glmm_fused": (_glmm(True), GLMM_LOCAL, GLMM_BLOCK, {"z": (G // 2,)}),
         "glmm_generic": (_glmm(False), GLMM_GENERIC, GLMM_BLOCK,
                          {"z": (G // 2,)})}


def _states(init, rng):
    """C chains around ``init``: each sampled site moved by a standard
    normal step (variances by a factor), the data as they are."""
    out = {}
    for k, v in init.items():
        v = np.asarray(v, dtype=float)
        if k == "y":
            out[k] = np.broadcast_to(v, (C,) + v.shape).copy()
        elif k.startswith("s2"):
            out[k] = v * rng.gamma(4.0, 0.25, size=(C,) + (1,) * v.ndim)
        else:
            out[k] = v + rng.normal(size=(C,) + v.shape)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_s_parts_of_a_block_call_match_the_reference(case):
    """Each rank's block call from the state it holds: its flat vector is
    the whole one's coordinates ``index``; the value summed over the
    ranks, the whole coordinates' gradient summed over the ranks and each
    rank's slice coordinates' gradient, as it stands, against the JAX
    package's block density and gradient at the same state (1e-10)."""
    import jax
    import mamba_tpu as jmt
    build, specs, block, held = CASES[case]
    model, inputs, init = build(tmt)
    ranks = [tmt.compile_model(model, inputs, init, device="cpu",
                               comm=_DataRank(r), site_specs=specs)
             for r in (0, 1)]
    np_state = _states(init, np.random.default_rng(5))
    state = {k: torch.as_tensor(v) for k, v in np_state.items()}
    jmodel, jinputs, jinit = build(jmt)
    jcm = jmt.compile_model(jmodel, jinputs, jinit)
    jpack, _, _, jlogf = jcm.block_functions(block, True)
    want_v, want_g = [], []
    for c in range(C):
        jst = {k: np.asarray(a[c]) for k, a in np_state.items()}
        jv, jg = jax.value_and_grad(jlogf)(jpack(jst), jst)
        want_v.append(float(jv))
        want_g.append(np.asarray(jg))
    want_v, want_g = np.array(want_v), np.stack(want_g)
    scale = np.abs(want_g).max()
    parts = []
    for cm in ranks:
        assert cm._held == {k: {0: ("data",)} for k in held}
        local = cm.cut_state(state)
        for k, shape in held.items():
            assert tuple(local[k].shape) == (C,) + shape
        pack, _, spec, logf = cm.block_functions(block, True)
        x = torch.func.vmap(pack)(local)
        coords = cm.block_coords(block)
        assert coords.dim == want_g.shape[1] and x.shape[1] == len(coords.index)
        np.testing.assert_allclose(x, np.stack([
            np.asarray(jpack({k: np.asarray(a[c]) for k, a in np_state.items()}))
            for c in range(C)])[:, coords.index.numpy()], rtol=1e-13)
        g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, local)
        parts.append((coords, v, g))
    np.testing.assert_allclose(parts[0][1] + parts[1][1], want_v, rtol=1e-10)
    coords0 = parts[0][0]
    whole_at = coords0.index[coords0.whole].numpy()
    np.testing.assert_allclose(
        sum(g[:, c.whole] for c, _, g in parts), want_g[:, whole_at],
        rtol=1e-10, atol=1e-10 * scale)
    for c, _, g in parts:
        np.testing.assert_allclose(g[:, c.part], want_g[:, c.index[c.part]],
                                   rtol=1e-10, atol=1e-10 * scale)
    # the slices of the two ranks cover the unsharded vector once, whole
    # coordinates on both
    covered = np.concatenate([c.index.numpy() for c, _, _ in parts])
    assert set(covered) == set(range(coords0.dim))
    assert len(covered) == coords0.dim + len(whole_at)


def _glmm_with(*samplers):
    """The G = 64 fused GLMM with ``samplers`` for its sites."""
    model, inputs, inits, _ = tglmm.build(G=G, n=10, seed=2, fused=True)
    model.set_samplers(list(samplers))
    return model, inputs, inits


#: which samplers hold z as the rank's slice: name -> (samplers, the
#: sampler that keeps it whole, None where it is held)
HOLDERS = {
    "nuts": (lambda: [tmt.NUTS(GLMM_BLOCK)], None),
    "chees": (lambda: [tmt.ChEESHMC(GLMM_BLOCK)], None),
    "hmc": (lambda: [tmt.HMC(GLMM_BLOCK, 0.05, 4)], None),
    "mala": (lambda: [tmt.MALA(GLMM_BLOCK, 0.01)], None),
    "hmc_dense": (lambda: [tmt.HMC(GLMM_BLOCK, 0.05, 4, np.eye(G + 5))], "HMC"),
    "mala_dense": (lambda: [tmt.MALA(GLMM_BLOCK, 0.01, np.eye(G + 5))], "MALA"),
    "slice": (lambda: [tmt.NUTS(("beta", "s2")), tmt.Slice("z", 1.0)], "Slice"),
    "amwg": (lambda: [tmt.NUTS(("beta", "s2")), tmt.AMWG("z", 0.5)], "AMWG"),
    "split": (lambda: [tmt.NUTS(("beta", "s2")), tmt.NUTS("z")], None),
    "mixed": (lambda: [tmt.NUTS(GLMM_BLOCK), tmt.Slice("z", 1.0)], "Slice"),
}


@pytest.mark.parametrize("name", list(HOLDERS))
def test_which_samplers_hold_a_slice(name):
    """z is held as the rank's slice only where every block that samples
    it can hold slices (NUTS, ChEES-HMC, unit-mass HMC and MALA); under a
    dense Sigma, Slice or AMWG it stays whole in the state, as before, the
    density's env holds its slice, and the compiler says which sampler
    kept it whole."""
    samplers, blocker = HOLDERS[name]
    held = blocker is None
    model, inputs, inits = _glmm_with(*samplers())
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu",
                           comm=_DataRank(1), site_specs=GLMM_LOCAL)
    assert ("z" in cm._held) == held
    assert cm._whole_reasons == ({} if held else {"z": (
        f"sampled by a block that cannot hold a slice ({blocker})")})
    assert cm.local_shape("z") == ((G // 2,) if held else (G,))
    assert ("z" in cm._env_dims) == (not held)
    for spec in model.samplers:
        coords = cm.block_coords(spec.params)
        assert (coords.index is not None) == (held and "z" in spec.params)


def test_a_site_a_centring_logical_reads_stays_whole():
    """rats with y reading alpha - mean(alpha): alpha, read whole by the
    recut logical, stays whole in the state; beta is held as the slice."""
    model, inputs, inits = trats.build("nuts")
    centred = tmt.Model(**{
        **model.nodes,
        "alpha_c": tmt.Logical(1, lambda alpha: alpha - torch.mean(alpha),
                               monitor=False),
        "y": tmt.Stochastic(2, lambda alpha_c, beta, Xm, s2_c: tmt.Normal(
            alpha_c[:, None] + beta[:, None] * Xm[None, :], torch.sqrt(s2_c)),
            monitor=False)})
    centred.set_samplers(model.samplers)
    cm = tmt.compile_model(centred, inputs, inits[0], device="cpu",
                           comm=_DataRank(0), site_specs=RATS_SPECS)
    assert (cm._held == {"beta": {0: ("data",)}}
            and cm._env_dims == {"alpha": {0: ("data",)}})
    assert cm._whole_reasons == {
        "alpha": "a logical computed from its whole value reads it"}
    assert cm.local_shape("alpha") == (30,) and cm.local_shape("beta") == (15,)


def test_a_slice_its_bijector_cannot_map_alone_is_named():
    """``_maps_slices`` on z's slices: the ranks' own distributions map
    them (no reason); a rank's distribution shaped as the whole, or one
    whose bijector maps the slice elsewhere, is named as the reason z
    would stay whole, and no error is raised."""
    model, inputs, inits = _glmm_with(tmt.NUTS(GLMM_BLOCK))
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu",
                           comm=_DataRank(0), site_specs=GLMM_LOCAL)
    value = torch.as_tensor(np.random.default_rng(3).normal(size=G))
    whole = tmt.Normal(torch.zeros(G), 1.0)
    local = [("local",)] * 2

    def why(*parts):
        return cm._maps_slices({0: ("data",)}, local, value, whole,
                               list(parts), 1e-8)
    half = tmt.Normal(torch.zeros(G // 2), 1.0)
    assert why(half, half) == ""
    assert why(whole, whole) == (f"data rank 0's distribution is shaped "
                                 f"({G},), beyond its slice's ({G // 2},)")
    assert why(half, tmt.Uniform(-10.0, 10.0)) == (
        "its bijector on data rank 1's slice is not the whole's")


# ---- across two gloo ranks ----------------------------------------------
RUN = dict(chains=4, device="cpu", verbose=False)
#: rats NUTS's run (iterations, burnin) and the restart's iterations
RATS_RUN, RATS_MORE = (6, 3), 4
#: the GLMM's runs: name -> (samplers, iterations, burnin)
GLMM_RUNS = {
    "chees": (lambda: [tmt.ChEESHMC(GLMM_BLOCK, max_steps=16, mass_window=3)],
              8, 6),
    "hmc": (lambda: [tmt.HMC(GLMM_BLOCK, 0.02, 4)], 6, 3),
    "mala": (lambda: [tmt.MALA(GLMM_BLOCK, 0.002)], 6, 3),
}
#: a warm-start inverse mass per coordinate of the unsharded (beta, z, s2)
#: vector, as ADVI gives it (``minv0``)
MINV0 = 0.5 + np.random.default_rng(7).uniform(size=G + 5)
#: NUTS and ChEES seeded with it: name -> (samplers, iterations, burnin)
MINV0_RUNS = {
    "nuts": (lambda: [tmt.NUTS(GLMM_BLOCK, max_depth=5, minv0=MINV0)], 5, 2),
    "chees": (lambda: [tmt.ChEESHMC(GLMM_BLOCK, max_steps=16, minv0=MINV0)],
              6, 3),
}
#: runs whose z stays whole: name -> (samplers, iterations, burnin)
WHOLE_RUNS = {
    "hmc_dense": (lambda: [tmt.HMC(GLMM_BLOCK, 0.02, 4, np.eye(G + 5))], 4, 2),
    "slice": (lambda: [tmt.NUTS(("beta", "s2")), tmt.Slice("z", 1.0)], 4, 2),
    "amwg": (lambda: [tmt.NUTS(("beta", "s2")), tmt.AMWG("z", 0.5)], 4, 2),
}


def _flat_tunes(tunes) -> np.ndarray:
    """Every floating leaf of a run's tunes, flattened in order."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                out.append(x.reshape(-1).double())
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, float):
            out.append(torch.tensor([x], dtype=torch.float64))
    walk(tunes)
    return torch.cat(out).numpy() if out else np.zeros(0)


def _result(sim, whole=None) -> dict:
    """A run's draws, tunes and final state, as one device holds them
    (``whole``: the rank's resume state gathered, ``fileio._whole_states``)."""
    st = whole or sim.states
    return {"value": sim.value, "tunes": _flat_tunes(st["tunes"]),
            **{f"state_{k}": v.numpy() for k, v in st["state"].items()}}


def _counting(shapes):
    """``MeshComm.data_sum`` recording each call's tensor shapes in
    ``shapes``."""
    inner = MeshComm.data_sum

    def data_sum(comm, *tensors):
        shapes.append([list(t.shape) for t in tensors])
        return inner(comm, *tensors)
    return data_sum


def _glmm_run(name, table, mesh=None):
    samplers, iters, burnin = table[name]
    model, inputs, inits = _glmm_with(*samplers())
    return tmt.mcmc(model, inputs, inits, iters, burnin=burnin, seed=4,
                    mesh=mesh, site_specs=GLMM_LOCAL if mesh else None, **RUN)


def _rats_model():
    """rats under NUTS with every stochastic node monitored: the kept rows
    of alpha and beta, held as slices, are gathered, and modelstats reads
    every sampled node's draws."""
    import dataclasses
    model, inputs, inits = trats.build("nuts")
    for n in model.keys("stochastic"):
        model.nodes[n] = dataclasses.replace(model.nodes[n], monitor=True)
    return model, inputs, inits


def _stats(sim) -> dict:
    """What modelstats reads from a run's kept rows."""
    return {"logpdf": tmt.logpdf_chains(sim).value, "dic": tmt.dic(sim).value,
            "predict": tmt.predict(sim, seed=1).value}


def _rats_run(mesh=None):
    model, inputs, inits = _rats_model()
    iters, burnin = RATS_RUN
    return tmt.mcmc(model, inputs, inits, iters, burnin=burnin, seed=11,
                    mesh=mesh, site_specs=RATS_SPECS if mesh else None, **RUN)


def _mode_rats(rank):
    from mamba_tpu_torch.output import fileio
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    sim = _rats_run(mesh)
    fileio.write_chains(str(Path(os.environ["MULTIPROC_OUT"]) / "rats.pkl"),
                        sim)
    state = sim.states["state"]
    return {**_result(sim, fileio._whole_states(sim)), **_stats(sim),
            "shapes": json.dumps({k: list(state[k].shape)
                                  for k in ("y", "alpha", "beta", "mu_beta")}),
            "minv_shape": np.array(sim.states["tunes"][0].minv.shape)}


def _mode_glmm(rank):
    from mamba_tpu_torch.output import fileio
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    out = {}
    inner = MeshComm.data_sum
    for name in GLMM_RUNS:
        shapes = []
        MeshComm.data_sum = _counting(shapes)
        try:
            sim = _glmm_run(name, GLMM_RUNS, mesh)
        finally:
            MeshComm.data_sum = inner
        res = _result(sim, fileio._whole_states(sim))
        out.update({f"{name}_{k}": v for k, v in res.items()})
        out[f"{name}_z_shape"] = np.array(sim.states["state"]["z"].shape)
        out[f"{name}_sums"] = json.dumps(shapes)
    return out


def _mode_whole(rank):
    from mamba_tpu_torch.output import fileio
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    out = {}
    for name in WHOLE_RUNS:
        sim = _glmm_run(name, WHOLE_RUNS, mesh)
        out.update({f"{name}_{k}": v for k, v in
                    _result(sim, fileio._whole_states(sim)).items()})
        out[f"{name}_z_shape"] = np.array(sim.states["state"]["z"].shape)
    return out


def _mode_minv0(rank):
    from mamba_tpu_torch.output import fileio
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    out = {}
    for name in MINV0_RUNS:
        sim = _glmm_run(name, MINV0_RUNS, mesh)
        out.update({f"{name}_{k}": v for k, v in
                    _result(sim, fileio._whole_states(sim)).items()})
        out[f"{name}_minv_shape"] = np.array(sim.states["tunes"][0].minv.shape)
    return out


def _ranks(mode, tmp_path, n=2):
    env = dict(os.environ, MULTIPROC_OUT=str(tmp_path))
    run_ranks(lambda r, init: [sys.executable, __file__, init, n, r, mode],
              n, timeout=RANKS_TIMEOUT, env=env)
    return [dict(np.load(tmp_path / f"{mode}{r}.npz")) for r in range(n)]


def _same_as(res, ref, prefix=""):
    """A two-rank run's draws, tunes and final state against the
    unsharded run's ``ref`` (``_result``) at 1e-8."""
    for k, v in ref.items():
        np.testing.assert_allclose(res[prefix + k], v, rtol=1e-8, atol=1e-10,
                                   err_msg=prefix + k)


@pytest.fixture(scope="module")
def rats_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rats")
    return tmp, _ranks("rats", tmp)


def test_rats_nuts_on_two_data_ranks_matches_the_unsharded_run(rats_ranks):
    """y, alpha and beta named, the JAX package's own data-mesh setup
    (__graft_entry__.py:57): each rank holds 15 of the 30 rats' alpha and
    beta and the NUTS tunes of its coordinates (32 of 62); the draws (alpha
    and beta monitored, their rows gathered), the tunes in the unsharded
    order, the final state, and `logpdf_chains`, DIC and `predict` from
    the kept rows equal the unsharded run's (1e-8), the same on both
    ranks."""
    _, (r0, r1) = rats_ranks
    for res in (r0, r1):
        assert json.loads(str(res["shapes"])) == {
            "y": [4, 15, 5], "alpha": [4, 15], "beta": [4, 15], "mu_beta": [4]}
        assert res["minv_shape"].tolist() == [4, 32]
    np.testing.assert_array_equal(r0["value"], r1["value"])
    np.testing.assert_array_equal(r0["tunes"], r1["tunes"])
    assert r0["value"].shape[1] == 216          # y's 150, alpha's and beta's 30
    ref = _rats_run()
    _same_as(r0, {**_result(ref), **_stats(ref)})


def test_a_sliced_run_s_file_restarts_on_one_device(rats_ranks):
    """The rats data-mesh run's one chain file, read on one device: alpha
    and beta whole, NUTS's per-coordinate tunes in the unsharded order,
    and its continuation equal to the unsharded run's (1e-8)."""
    from mamba_tpu_torch.output import fileio
    tmp, (r0, _) = rats_ranks
    model, inputs, _ = _rats_model()
    mc = fileio.read_chains(str(tmp / "rats.pkl"), model, inputs, device="cpu")
    assert not mc.compiled.comm.sharded
    assert tuple(mc.states["state"]["alpha"].shape) == (4, 30)
    assert tuple(mc.states["tunes"][0].minv.shape) == (4, 62)
    ref = _rats_run()
    np.testing.assert_allclose(_flat_tunes(mc.states["tunes"]),
                               _flat_tunes(ref.states["tunes"]), rtol=1e-8,
                               atol=1e-10)
    more = tmt.mcmc(mc, RATS_MORE, verbose=False)
    want = tmt.mcmc(ref, RATS_MORE, verbose=False)
    np.testing.assert_allclose(more.value, want.value, rtol=1e-8)
    np.testing.assert_array_equal(more.value[:mc.niter], r0["value"])


def test_glmm_on_two_data_ranks_matches_the_unsharded_runs(tmp_path):
    """y, xt and z named: under ChEES-HMC (its mass adapted per
    coordinate), HMC and MALA with unit mass each rank holds z's 32 of 64
    groups, and each run equals the unsharded one (1e-8).  Every
    all-reduce of a density call carries (C, 1 + whole dim) entries: the
    value and the 5 whole coordinates' gradient (beta, s2), never z's."""
    r0, r1 = _ranks("glmm", tmp_path)
    for name in GLMM_RUNS:
        ref = _result(_glmm_run(name, GLMM_RUNS))
        for res in (r0, r1):
            assert res[f"{name}_z_shape"].tolist() == [4, G // 2], name
            sums = json.loads(str(res[f"{name}_sums"]))
            calls = [s for s in sums if any(len(t) == 2 for t in s)]
            assert calls and all(s == [[4, 6]] for s in calls), (name, sums)
        np.testing.assert_array_equal(r0[f"{name}_value"], r1[f"{name}_value"])
        _same_as(r0, ref, f"{name}_")


def test_sites_that_stay_whole_run_as_before_on_two_data_ranks(tmp_path):
    """z under HMC with a dense Sigma, under Slice and under AMWG: whole
    in the state on each rank, and each run equals the unsharded one
    (1e-8), as it did before sampled sites were held as slices."""
    r0, r1 = _ranks("whole", tmp_path)
    for name in WHOLE_RUNS:
        ref = _result(_glmm_run(name, WHOLE_RUNS))
        for res in (r0, r1):
            assert res[f"{name}_z_shape"].tolist() == [4, G], name
        np.testing.assert_array_equal(r0[f"{name}_value"], r1[f"{name}_value"])
        _same_as(r0, ref, f"{name}_")


@pytest.fixture(scope="module")
def minv0_ranks(tmp_path_factory):
    return _ranks("minv0", tmp_path_factory.mktemp("minv0"))


@pytest.mark.parametrize("name", list(MINV0_RUNS))
def test_a_warm_start_mass_is_cut_to_the_rank_s_coordinates(minv0_ranks,
                                                             name):
    """NUTS and ChEES given a ``minv0`` of the unsharded length (69: beta's
    4, z's 64, s2's 1): each rank's inverse mass is its 37 coordinates of
    it (beta, its 32 groups of z, s2), and the run equals the unsharded
    one (1e-8) in draws, tunes and final state."""
    r0, r1 = minv0_ranks
    lead = [4] if name == "nuts" else []
    for res in (r0, r1):
        assert res[f"{name}_minv_shape"].tolist() == lead + [G // 2 + 5]
    np.testing.assert_array_equal(r0[f"{name}_value"], r1[f"{name}_value"])
    _same_as(r0, _result(_glmm_run(name, MINV0_RUNS)), f"{name}_")


def _main(argv) -> int:
    from mamba_tpu_torch.parallel import distributed_init
    init, n, rank, mode = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    distributed_init(init, n, rank, device_type="cpu", timeout=GROUP_TIMEOUT)
    try:
        out = {"rats": _mode_rats, "glmm": _mode_glmm,
               "whole": _mode_whole, "minv0": _mode_minv0}[mode](rank)
        np.savez(Path(os.environ["MULTIPROC_OUT"]) / f"{mode}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
