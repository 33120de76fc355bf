"""The port's mesh across processes: ranks of a gloo process group on the
CPU, each a copy of this file run as a script (the ``__main__`` block),
started by ``parallel.launch.run_ranks`` under one deadline (killed when
it passes) with a 60 s process-group timeout.

Counterpart of tests/test_multihost.py and the JAX package's mesh tests.
The JAX package folds every chain's index into its key, so its layouts
agree to rounding; the port's generator is one per chain rank, seeded from
``(seed, chain rank)``, so the exact checks here are the ones that layout
allows:

- a chain mesh: rank r's chains are bit for bit an unsharded run of its
  chains seeded as rank r, gathered in global order, and restart on the
  mesh the same way;
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
from mamba_tpu_torch.parallel.mesh import MeshComm, make_mesh, rank_seed

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
    path = Path(os.environ["MULTIPROC_OUT"]) / f"chains{rank}.pkl"
    fileio.write_chains(str(path), sim)
    try:
        fileio.read_chains(str(path), model, inputs, device="cpu")
        refused = False
    except ValueError as e:
        refused = "sharded run" in str(e)
    drawn = fileio.read_chains(str(path)).value
    more = tmt.mcmc(sim, 10, verbose=False)
    return {"value": sim.value, "restart": more.value, "refused": refused,
            "read_back": drawn, "local_beta": sim.states["state"]["beta"]}


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


MODES = {"chains": _chains, "data": _data, "chees": _chees, "smc": _smc,
         "glmm": _glmm, "dgs": _dgs, "rats": _rats}


def _ranks(mode, tmp_path, n=2, timeout=RANKS_TIMEOUT):
    """Run ``mode`` on ``n`` gloo ranks; every rank's saved arrays."""
    env = dict(os.environ, MULTIPROC_OUT=str(tmp_path))
    run_ranks(lambda r, init: [sys.executable, __file__, init, n, r, mode],
              n, timeout=timeout, env=env)
    return [dict(np.load(tmp_path / f"{mode}{r}.npz")) for r in range(n)]


# ---- the tests -----------------------------------------------------------
def test_chain_mesh_ranks_are_unsharded_runs_seeded_by_rank(tmp_path):
    r0, r1 = _ranks("chains", tmp_path)
    model, inputs, inits = tline.build()
    assert r0["value"].shape == (30, 3, 4)
    np.testing.assert_array_equal(r0["value"], r1["value"])
    np.testing.assert_array_equal(r0["restart"], r1["restart"])
    for r, res in enumerate((r0, r1)):
        # the inits recycle by global chain index; rank r holds 2r, 2r + 1
        own = [inits[k % len(inits)] for k in (2 * r, 2 * r + 1)]
        ref = tmt.mcmc(model, inputs, own, 40, burnin=10, chains=2,
                       seed=rank_seed(3, r), device="cpu", verbose=False)
        np.testing.assert_array_equal(res["value"][:, :, 2 * r:2 * r + 2],
                                      ref.value)
        np.testing.assert_array_equal(res["local_beta"],
                                      ref.states["state"]["beta"].numpy())
        more = tmt.mcmc(ref, 10, verbose=False)
        np.testing.assert_array_equal(res["restart"][:, :, 2 * r:2 * r + 2],
                                      more.value)
        # a rank's chain file holds every draw, but restarts only on the mesh
        assert bool(res["refused"])
        np.testing.assert_array_equal(res["read_back"], r0["value"])


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


@pytest.mark.slow
def test_rats_sharded_posterior_parity(tmp_path):
    """tests/test_parallel_engine.py:87-118 across 4 gloo ranks: a (2, 2)
    chains x data mesh against the unsharded run, posterior means within
    0.75 posterior SDs."""
    from mamba_tpu_torch.models import rats
    ranks = _ranks("rats", tmp_path, n=4, timeout=3600)
    for r in ranks:          # 15 rats of y per rank; alpha, beta whole
        assert json.loads(str(r["shapes"])) == [[4, 15, 5], [4, 30], [4, 30]]
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
