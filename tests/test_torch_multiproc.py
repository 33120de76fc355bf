"""The port's mesh across processes: ranks of a gloo process group on the
CPU, each a copy of this file run as a script (the ``__main__`` block),
started by ``parallel.launch.run_ranks`` under one deadline (killed when
it passes) with a 60 s process-group timeout.

Counterpart of tests/test_multihost.py and the JAX package's mesh tests.
Both packages fold every chain's global index into its key
(``ops/random.py``), so a chain draws the same numbers on any layout:

- a chain mesh: every rank's chains are the unsharded run's chains, to
  1e-8, gathered in global order, and restart on the mesh the same way
  (line under NUTS, line under HMC + Slice as tests/test_multihost.py runs
  it, rats NUTS and the G = 64 GLMM under ChEES, two chains a rank);
- a (1, 2) data mesh: the same random stream as the unsharded run, each
  rank holding its slice of the named inputs and observed sites and the
  density split between the two ranks: equal to 1e-8;
- ChEES's step size and trajectory identical on both ranks after every
  iteration, and SMC's particles identical on both ranks.

Float64 throughout (the CPU's default in the port)."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mamba_tpu_torch as tmt
from mamba_tpu_torch.models import glmm as tglmm, line as tline
from mamba_tpu_torch.parallel.launch import run_ranks
from mamba_tpu_torch.parallel.mesh import MeshComm, make_mesh

#: seconds a two-rank test may take, and a collective may wait
RANKS_TIMEOUT, GROUP_TIMEOUT = 120, 60


# ---- models (the workers build them too) --------------------------------
def conjugate_model():
    y = np.array([1.1, 0.7, 1.4, 0.9, 1.2, 1.0, 0.8, 1.3])
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu: tmt.Normal(mu.expand(8), 1.0),
                         monitor=False),
        mu=tmt.Stochastic(lambda: tmt.Normal(0.0, np.sqrt(2.0))))
    model.set_samplers([tmt.NUTS("mu")])
    v = 1 / (8 + 0.5)
    return model, y, v * y.sum()


def dgs_model():
    """Variable selection: 4 binary indicators under DGS, 7 observations
    (odd, so a data axis of 2 pads them)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(7, 4))
    coef = np.array([1.5, -2.0, 1.0, 0.5])
    y = X @ (coef * np.array([1, 0, 1, 0])) + 0.5 * rng.normal(size=7)
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu: tmt.Normal(mu, 0.5), monitor=False),
        mu=tmt.Logical(1, lambda x, coef, g: x @ (coef * g), monitor=False),
        g=tmt.Stochastic(1, lambda: tmt.Bernoulli(torch.full((4,), 0.5))),
    )
    model.set_samplers([tmt.DGS("g")])
    return model, {"x": X, "coef": coef}, [{"y": y, "g": np.ones(4)}]


LINE_SPECS = {"y": ("data",), "xmat": ("data", None)}
GLMM_SPECS = {"y": (None, "data")}


def glmm_states(G, C, seed=7):
    rng = np.random.default_rng(seed)
    return {"beta": rng.normal(size=(C, 4)), "z": rng.normal(size=(C, G)),
            "s2": rng.gamma(2.0, 0.5, size=C)}


# ---- worker modes: each returns arrays saved for the parent --------------
def _chains(rank):
    from mamba_tpu_torch.output import fileio
    model, inputs, inits = tline.build()
    mesh = make_mesh({"chains": 2}, "cpu")
    sim = tmt.mcmc(model, inputs, inits, 40, burnin=10, chains=4, seed=3,
                   mesh=mesh, device="cpu", verbose=False)
    path = Path(os.environ["MULTIPROC_OUT"]) / "chains.pkl"
    fileio.write_chains(str(path), sim)          # every rank, one file
    back = fileio.read_chains(str(path), model, inputs, device="cpu")
    drawn = fileio.read_chains(str(path)).value
    more = tmt.mcmc(sim, 10, verbose=False)
    return {"value": sim.value, "restart": more.value,
            "file_beta": back.states["state"]["beta"],
            "read_back": drawn, "local_beta": sim.states["state"]["beta"]}


def _line_hmc():
    """tests/test_multihost.py's line: HMC on beta, Slice on s2."""
    model, inputs, inits = tline.build()
    model.set_samplers([tmt.HMC("beta", 0.1, 10), tmt.Slice("s2", 2.0)])
    return model, inputs, inits


def _rats_nuts():
    from mamba_tpu_torch.models import rats
    return rats.build("nuts")


def _glmm_chees():
    model, inputs, inits, _ = tglmm.build(G=64, n=10, seed=2, fused=True,
                                          mass_window=50)
    model.set_samplers([tmt.ChEESHMC(model.samplers[0].params),
                        *model.samplers[1:]])
    return model, inputs, inits


def _line_constant_prior():
    """line with a node of four entries under a prior of constants, every
    entry missing and imputed by MISS: a batch of the unsharded run's chain
    count (four), drawn with the chains' keys leading the draw."""
    model, inputs, inits = tline.build()
    model.nodes["w"] = tmt.Stochastic(1, lambda: tmt.Normal(0.0, 1.0))
    model = tmt.Model(**model.nodes)
    model.set_samplers([tmt.HMC("beta", 0.1, 10), tmt.Slice("s2", 2.0),
                        tmt.MISS("w")])
    return model, inputs, [dict(i, w=np.full(4, np.nan)) for i in inits]


#: the runs held to their unsharded runs on a (2, 1) chain mesh: (build,
#: iterations, burnin, seed), four chains
LAYOUT_RUNS = {"line_hmc": (_line_hmc, 120, 60, 19),
               "rats_nuts": (_rats_nuts, 12, 6, 11),
               "glmm_chees": (_glmm_chees, 16, 8, 5),
               "line_constant_prior": (_line_constant_prior, 20, 10, 7)}


def _layouts(rank):
    mesh = make_mesh({"chains": 2}, "cpu")
    out = {}
    for name, (build, iters, burnin, seed) in LAYOUT_RUNS.items():
        model, inputs, inits = build()
        sim = tmt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=4,
                       seed=seed, mesh=mesh, device="cpu", verbose=False)
        out[name] = sim.value
        out[f"{name}_key"] = sim.states["key"].numpy()
    return out


def _data(rank):
    model, inputs, inits = tline.build()
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    sim = tmt.mcmc(model, inputs, inits, 10, burnin=5, chains=2, seed=3,
                   mesh=mesh, site_specs=LINE_SPECS, device="cpu",
                   verbose=False)
    return {"value": sim.value,
            "split": sim.compiled.block_split(("beta",)),
            "shapes": _local_shapes(sim, ("y", "xmat"))}


def _local_shapes(sim, names):
    """The shapes of ``names`` as this rank holds them (inputs, else the
    chain-stacked state), as JSON."""
    cm, state = sim.compiled, sim.states["state"]
    return json.dumps([list((cm.inputs[n] if n in cm.inputs else state[n]).shape)
                       for n in names])


def _chees(rank):
    from mamba_tpu_torch.samplers import chees
    model, inputs, inits = tline.build()
    model.set_samplers([tmt.ChEESHMC("beta"), tmt.Slice("s2", 2.0)])
    tunes = []
    inner = chees.chees_step

    def recording(*args, **kwargs):
        x, tune = inner(*args, **kwargs)
        tunes.append([float(tune.epsilon), float(tune.traj),
                      *tune.minv.tolist()])
        return x, tune

    chees.chees_step = recording
    mesh = make_mesh({"chains": 2}, "cpu")
    sim = tmt.mcmc(model, inputs, inits, 400, burnin=200, chains=8, seed=19,
                   mesh=mesh, device="cpu", verbose=False)
    s = tmt.summarystats(sim).to_dict()
    return {"tunes": np.array(tunes), "value": sim.value,
            "means": [s["beta[1]"]["Mean"], s["beta[2]"]["Mean"],
                      s["s2"]["Mean"]]}


def _smc(rank):
    model, y, _ = conjugate_model()
    mesh = make_mesh({"chains": 2}, "cpu")
    r = tmt.smc(model, {}, {"y": y, "mu": 0.0}, n_particles=1024, mesh=mesh,
                seed=4, device="cpu")
    return {"mu": r.particles["mu"], "log_evidence": r.log_evidence,
            "stages": r.n_stages}


def _glmm(rank):
    G, C = 64, 6
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    model, inputs, inits, _ = tglmm.build(G=G, n=10, seed=2, fused=True)
    kw = dict(device="cpu")
    whole = tmt.compile_model(model, inputs, inits[0], **kw)
    split = tmt.compile_model(model, inputs, inits[0], comm=MeshComm(mesh),
                              site_specs=GLMM_SPECS, **kw)
    state = {k: torch.as_tensor(v) for k, v in glmm_states(G, C).items()}
    state["y"] = torch.as_tensor(inits[0]["y"]).expand(C, 10, G)
    params = ("beta", "z", "s2")
    out = {}
    for name, cm in (("whole", whole), ("split", split)):
        local = cm.cut_state(state)            # the rank's slice of y
        pack, _, _, logf = cm.block_functions(params, True)
        x = torch.func.vmap(pack)(local)
        g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, local)
        v, g = cm.block_sum(params)(v, g)
        out[f"{name}_lp"], out[f"{name}_grad"] = v.numpy(), g.numpy()
    sim = tmt.mcmc(model, inputs, inits, 4, burnin=2, chains=4, seed=5,
                   mesh=mesh, site_specs=GLMM_SPECS, device="cpu",
                   verbose=False)
    out["value"] = sim.value
    out["shapes"] = _local_shapes(sim, ("y", "xt", "z"))
    return out


def _dgs(rank):
    model, inputs, inits = dgs_model()
    mesh = make_mesh({"chains": 1, "data": 2}, "cpu")
    sim = tmt.mcmc(model, inputs, inits, 30, burnin=10, chains=8, seed=2,
                   mesh=mesh, site_specs={"y": ("data",), "x": ("data", None)},
                   device="cpu", verbose=False)
    return {"value": sim.value, "split": sim.compiled.block_split(("g",)),
            "shapes": _local_shapes(sim, ("y", "x", "g"))}


def _rats(rank):
    from mamba_tpu_torch.models import rats
    model, inputs, inits = rats.build("nuts")
    mesh = make_mesh({"chains": 2, "data": 2}, "cpu")
    sim = tmt.mcmc(model, inputs, inits, 500, burnin=300, chains=8, seed=11,
                   mesh=mesh, device="cpu", verbose=False,
                   site_specs={"y": ("data",), "alpha": ("data",),
                               "beta": ("data",)})
    return {"value": sim.value,
            "shapes": _local_shapes(sim, ("y", "alpha", "beta"))}


#: the layouts of the chain-file restart tests: (mesh axes, site_specs)
RESTART_LAYOUTS = {"chains": ({"chains": 2}, None),
                   "data": ({"chains": 1, "data": 2}, LINE_SPECS)}
#: line's sharded run (iterations, burnin) and the restart's iterations
RESTART_RUN, RESTART_ITERS = (100, 20), 200
#: the mesh's own continuation's iterations per layout.  The data layout's
#: sums differ from one device's in their last bits (9e-15 in beta after
#: the first NUTS step) and NUTS amplifies that without flipping a
#: decision: this run stays within 1e-9 of the unsharded one for its
#: first 190 iterations and first passes 1e-8 at iteration 208 (PERF.md)
CONTINUED = {"chains": RESTART_ITERS, "data": 90}
#: ChEES's tunes of beta's length that every rank holds equally
CHEES_SHARED = ("minv", "w_mean", "w_m2", "w_sw")


def _restart(layout, chees=False):
    """line on ``layout``'s mesh: every rank writes the run's one chain
    file, and rank 0 also keeps the resume state gathered in memory (the
    same gather, no file: ``memory.pkl``) for the parent's one-device
    restart.  ``chees``: beta under ChEES (its tunes agreed across the
    ranks), the rank's own ChEES tunes and beta saved too."""
    import pickle
    from mamba_tpu_torch.output import fileio
    axes, specs = RESTART_LAYOUTS[layout]
    model, inputs, inits = tline.build()
    if chees:
        model.set_samplers([tmt.ChEESHMC("beta"), tmt.Slice("s2", 2.0)])
    iters, burnin = RESTART_RUN
    sim = tmt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=4,
                   seed=3, mesh=make_mesh(axes, "cpu"), site_specs=specs,
                   device="cpu", verbose=False)
    out = Path(os.environ["MULTIPROC_OUT"])
    fileio.write_chains(str(out / "file.pkl"), sim)
    memory = fileio._whole_states(sim)
    if dist.get_rank() == 0:
        with open(out / "memory.pkl", "wb") as f:
            pickle.dump(memory, f)
    out = {"value": sim.value, "shapes": _local_shapes(sim, ("y", "beta"))}
    if not chees:
        # the mesh's own continuation, which the file's one-device restart
        # is held to (on the data layout over its first iterations)
        out["continued"] = tmt.mcmc(sim, CONTINUED[layout],
                                    verbose=False).value
    if chees:
        tune = sim.states["tunes"][0]
        out.update({f: getattr(tune, f).numpy() for f in CHEES_SHARED},
                   beta=sim.states["state"]["beta"].numpy())
    return out


MODES = {"chains": _chains, "layouts": _layouts, "data": _data, "chees": _chees, "smc": _smc,
         "glmm": _glmm, "dgs": _dgs, "rats": _rats,
         "restart_chains": lambda rank: _restart("chains"),
         "restart_data": lambda rank: _restart("data"),
         "restart_chees": lambda rank: _restart("chains", chees=True)}


def _ranks(mode, tmp_path, n=2, timeout=RANKS_TIMEOUT):
    """Run ``mode`` on ``n`` gloo ranks; every rank's saved arrays."""
    env = dict(os.environ, MULTIPROC_OUT=str(tmp_path))
    run_ranks(lambda r, init: [sys.executable, __file__, init, n, r, mode],
              n, timeout=timeout, env=env)
    return [dict(np.load(tmp_path / f"{mode}{r}.npz")) for r in range(n)]


# ---- the tests -----------------------------------------------------------
def test_chain_mesh_ranks_are_slices_of_the_unsharded_run(tmp_path):
    r0, r1 = _ranks("chains", tmp_path)
    model, inputs, inits = tline.build()
    assert r0["value"].shape == (30, 3, 4)
    np.testing.assert_array_equal(r0["value"], r1["value"])
    np.testing.assert_array_equal(r0["restart"], r1["restart"])
    # every chain keyed by its global index: the unsharded run's chains
    ref = tmt.mcmc(model, inputs, inits, 40, burnin=10, chains=4, seed=3,
                   device="cpu", verbose=False)
    np.testing.assert_allclose(r0["value"], ref.value, rtol=1e-8)
    more = tmt.mcmc(ref, 10, verbose=False)
    np.testing.assert_allclose(r0["restart"], more.value, rtol=1e-8)
    beta = ref.states["state"]["beta"].numpy()
    for r, res in enumerate((r0, r1)):
        np.testing.assert_allclose(res["local_beta"], beta[2 * r:2 * r + 2],
                                   rtol=1e-8)
        # the run's one chain file holds every draw and every chain's state
        np.testing.assert_array_equal(res["read_back"], r0["value"])
        np.testing.assert_allclose(res["file_beta"], beta, rtol=1e-8)


@pytest.mark.parametrize("name", list(LAYOUT_RUNS))
def test_two_chain_ranks_equal_the_unsharded_run(tmp_path_factory, name,
                                                 layout_ranks):
    """Two gloo chain ranks of two chains each, against the four-chain run
    without a mesh, in float64: the draws at 1e-8, every chain's final key
    exactly."""
    r0, r1 = layout_ranks
    build, iters, burnin, seed = LAYOUT_RUNS[name]
    model, inputs, inits = build()
    ref = tmt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=4,
                   seed=seed, device="cpu", verbose=False)
    np.testing.assert_array_equal(r0[name], r1[name])
    np.testing.assert_allclose(r0[name], ref.value, rtol=1e-8, atol=1e-12)
    keys = ref.states["key"].numpy()
    np.testing.assert_array_equal(r0[f"{name}_key"], keys[:2])
    np.testing.assert_array_equal(r1[f"{name}_key"], keys[2:])


@pytest.fixture(scope="module")
def layout_ranks(tmp_path_factory):
    """``LAYOUT_RUNS`` on two gloo chain ranks, once for the module."""
    return _ranks("layouts", tmp_path_factory.mktemp("layouts"),
                  timeout=2 * RANKS_TIMEOUT)


def test_data_mesh_matches_the_unsharded_run(tmp_path):
    r0, r1 = _ranks("data", tmp_path)
    assert bool(r0["split"])
    # each rank holds 3 of y's 6 (padded) entries and xmat's rows
    for res in (r0, r1):
        assert json.loads(str(res["shapes"])) == [[2, 3], [3, 2]]
    np.testing.assert_array_equal(r0["value"], r1["value"])
    model, inputs, inits = tline.build()
    ref = tmt.mcmc(model, inputs, inits, 10, burnin=5, chains=2, seed=3,
                   device="cpu", verbose=False)
    # the same random stream; only the density's summation order differs
    np.testing.assert_allclose(r0["value"], ref.value, rtol=1e-8)


def test_chees_tunes_agree_across_ranks(tmp_path):
    r0, r1 = _ranks("chees", tmp_path)
    assert len(r0["tunes"]) == 400
    np.testing.assert_array_equal(r0["tunes"], r1["tunes"])
    np.testing.assert_array_equal(r0["value"], r1["value"])
    b1, b2, s2 = r0["means"]
    # tests/test_multihost.py:135-147
    assert abs(b1 - 0.6) < 1.0 and abs(b2 - 0.8) < 0.3 and 0.3 < s2 < 5.0


def test_smc_with_sharded_particles(tmp_path):
    r0, r1 = _ranks("smc", tmp_path)
    assert r0["mu"].shape == (1024,)
    np.testing.assert_array_equal(r0["mu"], r1["mu"])
    _, _, m_exact = conjugate_model()
    assert abs(r0["mu"].mean() - m_exact) < 0.06   # tests/test_infer.py:105-112


def test_glmm_split_by_groups_over_a_data_mesh(tmp_path):
    r0, r1 = _ranks("glmm", tmp_path)
    for res in (r0, r1):
        # y's 32 of 64 groups per rank; xt and z (not named) whole
        assert json.loads(str(res["shapes"])) == [[4, 10, 32], [4, 10, 64], [4, 64]]
        np.testing.assert_allclose(res["split_lp"], res["whole_lp"],
                                   rtol=1e-10)
        scale = np.abs(res["whole_grad"]).max()
        assert np.abs(res["split_grad"] - res["whole_grad"]).max() <= 1e-10 * scale
    np.testing.assert_array_equal(r0["value"], r1["value"])
    model, inputs, inits, _ = tglmm.build(G=64, n=10, seed=2, fused=True)
    ref = tmt.mcmc(model, inputs, inits, 4, burnin=2, chains=4, seed=5,
                   device="cpu", verbose=False)
    np.testing.assert_allclose(r0["value"], ref.value, rtol=1e-8)


def test_dgs_over_a_data_mesh(tmp_path):
    r0, r1 = _ranks("dgs", tmp_path)
    assert bool(r0["split"])
    for res in (r0, r1):             # 4 of the 7 (padded to 8) observations
        assert json.loads(str(res["shapes"])) == [[8, 4], [4, 4], [8, 4]]
    np.testing.assert_array_equal(r0["value"], r1["value"])
    model, inputs, inits = dgs_model()
    ref = tmt.mcmc(model, inputs, inits, 30, burnin=10, chains=8, seed=2,
                   device="cpu", verbose=False)
    np.testing.assert_array_equal(r0["value"], ref.value)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX package's chain files of line for each layout's mesh shape
    (GSPMD over two of the host devices, the same run), read as dicts, and
    its restart from its own chain-mesh file.  Its data-mesh file holds y
    padded to 6 and does not restart against line's inputs (ROADMAP,
    faults of the reference)."""
    import pickle
    import jax
    import mamba_tpu as jmt
    from jax.sharding import PartitionSpec as P
    from mamba_tpu.output import fileio as jfileio
    from mamba_tpu.parallel import make_mesh as jmesh
    model, inputs, inits = jmt.models.line.build()
    iters, burnin = RESTART_RUN
    out = {}
    for layout, (axes, specs) in RESTART_LAYOUTS.items():
        path = tmp_path_factory.mktemp("jax") / f"{layout}.pkl"
        sim = jmt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=4,
                       seed=3, mesh=jmesh(axes, devices=jax.devices()[:2]),
                       site_specs=specs and {k: P(*v) for k, v in specs.items()},
                       verbose=False)
        jfileio.write_chains(str(path), sim)
        with open(path, "rb") as f:
            out[layout] = pickle.load(f)
        if layout == "chains":
            mc = jfileio.read_chains(str(path), model, inputs)
            out["restart"] = np.asarray(
                jmt.mcmc(mc, RESTART_ITERS, verbose=False).value)[-RESTART_ITERS:]
    return out


def _leaf_shapes(tune):
    return {f: tuple(np.shape(v)) for f, v in zip(tune._fields, tune)}


@pytest.mark.parametrize("layout", list(RESTART_LAYOUTS))
def test_a_sharded_run_s_file_restarts_on_one_device(tmp_path, layout,
                                                     jax_files):
    """Two gloo ranks write line's chain file on a (2, 1) chain mesh or a
    (1, 2) data mesh (y padded 5 -> 6 there).  Read back on the CPU it is
    the unsharded run's layout, as the JAX package's file is; it restarts
    on one device equal to the restart from the gathered in-memory state
    (1e-12) and to the mesh's own continuation (1e-8), its draws, state
    and keys are the unsharded run's (1e-8), and its restart's posterior
    means agree with the JAX package's restart from its own file."""
    import pickle
    from mamba_tpu_torch.output import fileio
    r0, r1 = _ranks(f"restart_{layout}", tmp_path)
    np.testing.assert_array_equal(r0["value"], r1["value"])
    model, inputs, inits = tline.build()
    iters, burnin = RESTART_RUN
    with open(tmp_path / "file.pkl", "rb") as f:
        payload = pickle.load(f)
    mc = fileio.read_chains(str(tmp_path / "file.pkl"), model, inputs,
                            device="cpu")
    assert not mc.compiled.comm.sharded and "shard" not in payload
    np.testing.assert_array_equal(mc.value, r0["value"])
    state = mc.states["state"]
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        "beta": (4, 2), "s2": (4,), "y": (4, 5)}          # padding dropped
    np.testing.assert_array_equal(state["y"], np.broadcast_to(inits[0]["y"], (4, 5)))
    assert payload["states"]["key"].shape == (4, 2)

    # the JAX package's file for the same model and mesh shape
    jp = jax_files[layout]
    assert set(payload) - {"device", "dtype"} == set(jp)
    assert set(payload["states"]) == set(jp["states"])
    for k in ("names", "start", "thin", "iter", "chains"):
        assert payload[k] == (list(jp[k]) if k == "names" else jp[k]), k
    assert payload["value"].shape == jp["value"].shape
    jshapes = {k: np.shape(v) for k, v in jp["states"]["state"].items()}
    if layout == "data":                  # the JAX file keeps y's padding
        assert jshapes.pop("y") == (4, 6)
        jshapes["y"] = (4, 5)
    assert {k: tuple(v.shape) for k, v in state.items()} == jshapes
    port_nuts, jax_nuts = (_leaf_shapes(t[0]) for t in
                           (mc.states["tunes"], jp["states"]["tunes"]))
    common = set(port_nuts) & set(jax_nuts)
    assert len(common) >= 15
    assert {f: port_nuts[f] for f in common} == {f: jax_nuts[f] for f in common}

    # the restart from the file, against the one-device restart from the
    # resume state gathered in memory
    more = _restarts_as_in_memory(tmp_path, mc, model, inputs, r0["value"])
    # every chain continues its own stream: the mesh's own continuation
    # (``CONTINUED``: on the data layout its first 90 iterations)
    kept = r0["continued"].shape[0]
    assert kept == RESTART_RUN[0] - RESTART_RUN[1] + CONTINUED[layout]
    np.testing.assert_allclose(more.value[:kept], r0["continued"], rtol=1e-8)

    # the file's keys and state are the unsharded run's on either layout
    ref = tmt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=4,
                   seed=3, device="cpu", verbose=False)
    assert torch.equal(payload["states"]["key"], ref.states["key"])
    np.testing.assert_allclose(mc.value, ref.value, rtol=1e-8)
    for k, v in ref.states["state"].items():
        np.testing.assert_allclose(state[k], v, rtol=1e-8, err_msg=k)

    # tests/test_torch_multiproc.py's rats criterion: posterior means
    # within 0.75 posterior SDs of the JAX package's restart from its file
    a, b = jax_files["restart"], more.value[-RESTART_ITERS:]
    sd = np.maximum(a.std((0, 2)), 1e-3)
    z = np.abs(a.mean((0, 2)) - b.mean((0, 2))) / sd
    assert z.max() < 0.75, (mc.names[int(np.argmax(z))], z)


def _restarts_as_in_memory(tmp_path, mc, model, inputs, value):
    """``mc``, read from a sharded run's file, restarted on one device:
    equal to the restart from the resume state the ranks gathered in
    memory (``memory.pkl``) at 1e-12, finite, its range contiguous."""
    import pickle
    from mamba_tpu_torch.output.chains import ModelChains
    iters, burnin = RESTART_RUN
    with open(tmp_path / "memory.pkl", "rb") as f:
        memory = pickle.load(f)
    cm = tmt.compile_model(model, inputs, {k: v[0].numpy() for k, v in
                                           memory["state"].items()}, device="cpu")
    in_memory = ModelChains(value, start=burnin + 1, thin=1,
                            names=mc.names, chains=mc.chains, model=model,
                            compiled=cm, states=memory, iter=iters)
    more = tmt.mcmc(mc, RESTART_ITERS, verbose=False)
    want = tmt.mcmc(in_memory, RESTART_ITERS, verbose=False)
    np.testing.assert_array_equal(more.range, np.arange(burnin + 1, iters + RESTART_ITERS + 1))
    np.testing.assert_allclose(more.value, want.value, rtol=1e-12)
    assert np.isfinite(more.value).all()
    return more


def test_a_chees_file_keeps_what_every_rank_holds_once(tmp_path):
    """ChEES on line's beta over a (2, 1) chain mesh, two chains per rank:
    its mass matrix and window sums have beta's two entries, as many as a
    rank's chains.  The file keeps them once, as every rank holds them,
    and joins beta's chains over the ranks; it restarts on one device as
    the gathered in-memory state does."""
    from mamba_tpu_torch.output import fileio
    from mamba_tpu_torch.samplers.chees import ChEESTune
    r0, r1 = _ranks("restart_chees", tmp_path)
    model, inputs, _ = tline.build()
    model.set_samplers([tmt.ChEESHMC("beta"), tmt.Slice("s2", 2.0)])
    mc = fileio.read_chains(str(tmp_path / "file.pkl"), model, inputs,
                            device="cpu")
    tune = mc.states["tunes"][0]
    assert isinstance(tune, ChEESTune)
    for f in CHEES_SHARED:
        assert r0[f].shape == (2,), f
        np.testing.assert_array_equal(r0[f], r1[f], err_msg=f)
        np.testing.assert_array_equal(getattr(tune, f), r0[f], err_msg=f)
    beta = mc.states["state"]["beta"]
    assert beta.shape == (4, 2)
    np.testing.assert_array_equal(beta[:2], r0["beta"])
    np.testing.assert_array_equal(beta[2:], r1["beta"])
    _restarts_as_in_memory(tmp_path, mc, model, inputs, r0["value"])


@pytest.mark.slow
def test_rats_sharded_posterior_parity(tmp_path):
    """tests/test_parallel_engine.py:87-118 across 4 gloo ranks: a (2, 2)
    chains x data mesh against the unsharded run, posterior means within
    0.75 posterior SDs."""
    from mamba_tpu_torch.models import rats
    ranks = _ranks("rats", tmp_path, n=4, timeout=3600)
    for r in ranks:          # 15 rats of y, alpha and beta per rank
        assert json.loads(str(r["shapes"])) == [[4, 15, 5], [4, 15], [4, 15]]
    res = ranks[0]
    model, inputs, inits = rats.build("nuts")
    plain = tmt.mcmc(model, inputs, inits, 500, burnin=300, chains=8,
                     seed=11, device="cpu", verbose=False)
    a, b = plain.value, res["value"]
    sd = np.maximum(a.std((0, 2)), 1e-3)
    z = np.abs(a.mean((0, 2)) - b.mean((0, 2))) / sd
    assert z.max() < 0.75, plain.names[int(np.argmax(z))]


@pytest.mark.slow
def test_dryrun_multichip_over_four_gloo_ranks():
    from mamba_tpu_torch.graft_entry import dryrun_multichip
    dryrun_multichip(4, device="cpu")


def _main(argv) -> int:
    from mamba_tpu_torch.parallel import distributed_init
    init, n, rank, mode = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    distributed_init(init, n, rank, device_type="cpu", timeout=GROUP_TIMEOUT)
    try:
        out = MODES[mode](rank)
        np.savez(Path(os.environ["MULTIPROC_OUT"]) / f"{mode}{rank}.npz",
                 **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
