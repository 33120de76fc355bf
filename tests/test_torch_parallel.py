"""The port's ``parallel`` package in one process, against the JAX
package's (tests/test_parallel_engine.py, tests/test_profiling.py:42-46):
``pad_axes``/``pad_mask``, the padded and masked densities, a mesh run
against the JAX package's mesh run, and what only the port has: one-rank
meshes that replay the run without a mesh bit for bit, and a data axis's
parts of a density, evaluated here rank by rank, that sum to the whole.

The runs across processes are in tests/test_torch_multiproc.py."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu_torch.ops import random as R
from mamba_tpu.models import glmm as jglmm, line as jline
from mamba_tpu.parallel import make_mesh as jmake_mesh
from mamba_tpu.parallel.mesh import pad_axes as jpad_axes, pad_mask as jpad_mask
from mamba_tpu_torch.graft_entry import dryrun_multichip, entry
from mamba_tpu_torch.model.mcmc import _pad_sharded
from mamba_tpu_torch.models import glmm as tglmm, line as tline
from mamba_tpu_torch.parallel import (chain_sharding, make_mesh,
                                      shard_chain_tree)
from mamba_tpu_torch.parallel.mesh import (MeshComm, pad_axes, pad_mask)
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _one_rank_world():
    """The world group these tests' one-rank meshes start; it goes with
    the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(axes=None):
    return make_mesh(axes, "cpu")


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


LINE_SPECS = {"y": ("data",), "xmat": ("data", None)}
SIZES = {"chains": 4, "data": 2}


# ---- pad_axes / pad_mask -------------------------------------------------
X5 = np.stack([np.ones(5), np.arange(1.0, 6.0)], 1)
Z57 = np.arange(35.0).reshape(5, 7)


@pytest.mark.parametrize("axes, specs, arrays", [
    # the reference's cases (tests/test_parallel_engine.py:57-85)
    (SIZES, {"y": ("data",), "xmat": ("data", None)},
     {"xmat": X5, "y": np.array([1.0, 3.0, 3.0, 3.0, 5.0])}),
    (SIZES, {"y": ("data",)}, {"y": np.arange(6.0)}),
    # a 2-D spec, and one dim over two axes
    ({"chains": 2, "data": 2, "model": 2}, {"z": ("data", "model")},
     {"z": Z57}),
    ({"chains": 2, "data": 2, "model": 2}, {"z": (None, ("data", "model"))},
     {"z": Z57}),
])
def test_pad_axes_and_pad_mask_match_the_reference(axes, specs, arrays):
    n = int(np.prod(list(axes.values())))
    jmesh = jmake_mesh(axes, __import__("jax").devices()[:n])
    out, pads = pad_axes(axes, specs, arrays)
    jout, jpads = jpad_axes(jmesh, {k: P(*v) for k, v in specs.items()}, arrays)
    assert pads == jpads
    assert out.keys() == jout.keys()
    for k in out:
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]))
    for k, p in pads.items():
        np.testing.assert_array_equal(pad_mask(out[k].shape, p),
                                      jpad_mask(out[k].shape, p))


def test_pad_axes_names_a_dim_the_array_lacks():
    with pytest.raises(ValueError, match="names dim 1"):
        pad_axes(SIZES, {"y": (None, "data")}, {"y": np.arange(5.0)})


# ---- padded and masked densities -----------------------------------------
def _padded_line(pkg_line, axes=SIZES):
    model, inputs, inits = pkg_line.build()
    p_inputs, _ = pad_axes(axes, LINE_SPECS, inputs)
    p_init, pads = pad_axes(axes, LINE_SPECS, inits[0])
    masks = {"y": pad_mask(p_init["y"].shape, pads["y"])}
    return model, inputs, inits[0], p_inputs, p_init, masks


@pytest.mark.parametrize("transform", [None, True, False])
def test_padded_masked_density_matches_the_reference(transform):
    """logpdf (None) and the (beta, s2) block logf in both spaces: the
    padded, masked compiled model equals the JAX package's, and its own
    unpadded density (rtol 1e-12)."""
    tm, t_in, t_init, tp_in, tp_init, masks = _padded_line(tline)
    jm, _, _, jp_in, jp_init, _ = _padded_line(jline)
    assert masks["y"].tolist() == [True] * 5 + [False]
    tcm = tmt.compile_model(tm, tp_in, tp_init, device="cpu", masks=masks)
    tcm0 = tmt.compile_model(tm, t_in, t_init, device="cpu")
    jcm = jmt.compile_model(jm, jp_in, jp_init, masks=masks)
    st = convert.to_tensors({k: tp_init[k] for k in tcm.stochastic}, "cpu",
                            torch.float64)
    st0 = convert.to_tensors({k: t_init[k] for k in tcm.stochastic}, "cpu",
                             torch.float64)
    jst = {k: np.asarray(tp_init[k], float) for k in jcm.stochastic}
    if transform is None:
        got, whole, ref = tcm.logpdf(st), tcm0.logpdf(st0), jcm.logpdf(jst)
    else:
        blk = ("beta", "s2")
        pk, _, _, lf = tcm.block_functions(blk, transform)
        pk0, _, _, lf0 = tcm0.block_functions(blk, transform)
        jpk, _, _, jlf = jcm.block_functions(blk, transform)
        got, whole = lf(pk(st), st), lf0(pk0(st0), st0)
        ref = jlf(jpk(jst), jst)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)
    np.testing.assert_allclose(float(got), float(whole), rtol=1e-12)


def _parts(cm_of_rank, params, state, transform):
    """Each data rank's block logf and gradient at ``state`` (chains
    stacked, whole), from the rank's local state, and their sums over the
    ranks."""
    lps, grads = [], []
    for r in (0, 1):
        cm = cm_of_rank(r)
        assert cm.block_split(params)
        local = cm.cut_state(state)
        pack, _, _, logf = cm.block_functions(params, transform)
        x = torch.func.vmap(pack)(local)
        g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, local)
        lps.append(v)
        grads.append(g)
    return lps, grads


@pytest.mark.parametrize("transform", [True, False])
def test_line_density_parts_sum_to_the_whole(transform):
    """Each data rank holds and sums its slice of y (padded 5 -> 6) and
    rank 0 the priors and the Jacobian: the parts sum to the density."""
    tm, _, _, p_in, p_init, masks = _padded_line(tline, {"chains": 1, "data": 2})
    whole = tmt.compile_model(tm, p_in, p_init, device="cpu", masks=masks)
    rng = np.random.default_rng(1)
    C = 3
    state = {"y": torch.as_tensor(p_init["y"]).expand(C, 6),
             "beta": torch.as_tensor(rng.normal(size=(C, 2))),
             "s2": torch.as_tensor(rng.gamma(2.0, 0.5, size=C))}
    lps, grads = _parts(lambda r: tmt.compile_model(
        tm, p_in, p_init, device="cpu", masks=masks, comm=_DataRank(r),
        site_specs=LINE_SPECS), ("beta", "s2"), state, transform)
    pack, _, _, logf = whole.block_functions(("beta", "s2"), transform)
    x = torch.func.vmap(pack)(state)
    g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, state)
    np.testing.assert_allclose(lps[0] + lps[1], v, rtol=1e-12)
    np.testing.assert_allclose(grads[0] + grads[1], g, rtol=1e-12, atol=1e-12)
    # the slice of y alone on rank 1: no prior, no Jacobian
    s = state["s2"][:, None]
    mu = state["beta"] @ torch.as_tensor(p_in["xmat"]).T
    own = torch.distributions.Normal(mu[:, 3:5], torch.sqrt(s)).log_prob(
        state["y"][:, 3:5]).sum(-1)
    np.testing.assert_allclose(lps[1], own, rtol=1e-12)


def test_glmm_density_parts_are_the_kernel_over_each_range_of_groups():
    """The fused GLMM's (n, G) event splits by groups: rank r holds y's
    G/2 groups, and its part is the kernel (its plain version here) over
    them; the parts sum to the whole density and gradient."""
    G, C = 40, 5
    model, inputs, inits, _ = tglmm.build(G=G, n=10, seed=2, fused=True)
    whole = tmt.compile_model(model, inputs, inits[0], device="cpu")
    rng = np.random.default_rng(3)
    state = {"y": torch.as_tensor(inits[0]["y"]).expand(C, 10, G),
             "beta": torch.as_tensor(rng.normal(size=(C, 4))),
             "z": torch.as_tensor(rng.normal(size=(C, G))),
             "s2": torch.as_tensor(rng.gamma(2.0, 0.5, size=C))}
    params = ("beta", "z", "s2")
    cms = {r: tmt.compile_model(model, inputs, inits[0], device="cpu",
                                comm=_DataRank(r),
                                site_specs={"y": (None, "data")})
           for r in (0, 1)}
    lps, grads = _parts(cms.__getitem__, params, state, True)
    pack, _, _, logf = whole.block_functions(params, True)
    x = torch.func.vmap(pack)(state)
    g, v = torch.func.vmap(torch.func.grad_and_value(logf))(x, state)
    np.testing.assert_allclose(lps[0] + lps[1], v, rtol=1e-12)
    np.testing.assert_allclose(grads[0] + grads[1], g, rtol=1e-12, atol=1e-10)
    from mamba_tpu_torch.ops.fused_glmm import glmm_loglik_grads_plain
    Xt = torch.as_tensor(inputs["xt"])
    b = torch.sqrt(state["s2"])[:, None] * state["z"]
    own, _, _ = glmm_loglik_grads_plain(Xt[:, :, 20:], state["y"][0][:, 20:],
                                        state["beta"], b[:, 20:])
    np.testing.assert_allclose(lps[1], own, rtol=1e-12)
    # the covariates' slice is cut once, when the split is planned
    plan = cms[1]._local_plans["y"]
    assert plan[:3] == ("range", 20, 40) and plan[3].is_contiguous()
    np.testing.assert_array_equal(plan[3], Xt[:, :, 20:])


def test_reference_drops_the_whole_glmm_likelihood_under_a_partial_mask():
    """The JAX package reduces a mask over the fused GLMM's one (n, G)
    event with AND (mamba_tpu/model/compile.py:183-185): a padded or
    partial mask drops the whole likelihood.  The port takes a mask that
    keeps whole groups as the kernel over those groups, and refuses one
    that splits a group."""
    G, n = 24, 5
    jm, jin, jinit, _ = jglmm.build(G=G, n=n, seed=1, fused=True)
    tm, tin, tinit, _ = tglmm.build(G=G, n=n, seed=1, fused=True)
    jg, jgin, jginit, _ = jglmm.build(G=G, n=n, seed=1, fused=False)
    rng = np.random.default_rng(7)
    st = {"beta": rng.normal(size=4), "z": rng.normal(size=G), "s2": 0.8,
          "y": tinit[0]["y"]}
    jst = {k: np.asarray(v, float) for k, v in st.items()}
    pad = np.ones((n, G), bool)
    pad[:, 20:] = False                         # four padded groups
    jcm = jmt.compile_model(jm, jin, jinit[0], masks={"y": pad})
    prior_only = jmt.compile_model(jm, jin, jinit[0]).logpdf(
        jst, terms=("z", "beta", "s2"))
    np.testing.assert_allclose(float(jcm.logpdf(jst)), float(prior_only),
                               rtol=1e-12)
    # the port: the 20 real groups' likelihood, as the generic build's
    tcm = tmt.compile_model(tm, tin, tinit[0], device="cpu", masks={"y": pad})
    jgcm = jmt.compile_model(jg, jgin, jginit[0], masks={"y": pad.T})
    jgst = dict(jst, y=np.asarray(jginit[0]["y"], float))
    got = tcm.logpdf(convert.to_tensors(st, "cpu", torch.float64))
    np.testing.assert_allclose(float(got), float(jgcm.logpdf(jgst)),
                               rtol=1e-10)
    part = pad.copy()
    part[0, 3] = False                          # one observation of a group
    with pytest.raises(ValueError, match="takes part of an event"):
        tmt.compile_model(tm, tin, tinit[0], device="cpu", masks={"y": part})


# ---- meshes of one rank --------------------------------------------------
def test_make_mesh_rejects_a_shape_that_is_not_the_world():
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        _mesh({"chains": 2})
    mesh = _mesh()
    assert mesh.mesh_dim_names == ("chains",) and mesh.size() == 1
    with pytest.raises(TypeError, match="DeviceMesh"):
        MeshComm(object())
    with pytest.raises(ValueError, match="no chain axis"):
        MeshComm(_mesh({"data": 1}))
    # several data axes: a one-rank comm of two is the identity
    comm = MeshComm(_mesh({"chains": 1, "a": 1, "b": 1}))
    assert comm.data_axes == ("a", "b") and comm.data_shape == (1, 1)
    assert comm.data_size == 1 and comm.data_rank == 0 and not comm.sharded
    x = torch.arange(6.0).reshape(2, 3)
    assert comm.data_sum(x)[0] is x and comm.data_sum(x, axes=("b",))[0] is x
    assert comm.gather_data(x, {0: ("a",), 1: ("b",)}) is x


def test_comm_of_one_rank_is_the_identity():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(6, 3)))
    for comm in (MeshComm(), MeshComm(_mesh({"chains": 1, "data": 1}))):
        assert not comm.sharded
        assert torch.equal(comm.chain_mean(x), torch.mean(x, dim=0))
        assert comm.gather_chains(x, dim=1) is x
        assert comm.data_sum(x)[0] is x and comm.chain_sum(x)[0] is x
        assert comm.chain_broadcast(x) is x
        assert comm.local_chains(5) == 5


def test_chain_sharding_of_one_rank_and_the_rank_seeds():
    mesh = _mesh()
    assert chain_sharding(mesh, 8) == slice(0, 8)
    tree = {"x": np.zeros((8, 3)), "k": 3, "t": (torch.ones(8), np.ones(2))}
    out = shard_chain_tree(tree, mesh, 8)
    assert out["x"].shape == (8, 3) and out["k"] == 3
    assert out["t"][1].shape == (2,)
    # a rank's streams: its chains' keys, by their global indices, are its
    # rows of every chain's keys, and no two chains share one
    every = R.chain_keys(3, range(8))
    np.testing.assert_array_equal(R.chain_keys(3, range(4, 8)), every[4:])
    assert len({tuple(k) for k in every.tolist()}) == 8
    assert not torch.equal(R.chain_keys(4, range(8)), every)


@pytest.mark.parametrize("scheme", ["nuts", "chees", "nuts-specs"])
def test_one_rank_mesh_replays_the_run_without_a_mesh(scheme):
    model, inputs, inits = tline.build()
    kw = dict(burnin=20, chains=4, seed=3, verbose=False, device="cpu")
    if scheme == "chees":
        model.set_samplers([tmt.ChEESHMC("beta", mass_window=5),
                            tmt.Slice("s2", 2.0)])
    plain = tmt.mcmc(model, inputs, inits, 60, **kw)
    if scheme == "nuts-specs":
        mesh = _mesh({"chains": 1, "data": 1})
        kw["site_specs"] = LINE_SPECS
    else:
        mesh = _mesh()
    sim = tmt.mcmc(model, inputs, inits, 60, mesh=mesh, **kw)
    np.testing.assert_array_equal(sim.value, plain.value)
    np.testing.assert_array_equal(tmt.mcmc(sim, 10, verbose=False).value,
                                  tmt.mcmc(plain, 10, verbose=False).value)


def test_one_rank_mesh_replays_smc():
    model, _, _ = tline.build()
    y = np.array([1.0, 3.0, 3.0, 3.0, 5.0])
    kw = dict(n_particles=256, rejuvenation_steps=5, seed=1, device="cpu")
    init = {"y": y, "beta": np.zeros(2), "s2": 1.0}
    a = tmt.smc(model, tline.build()[1], init, **kw)
    b = tmt.smc(model, tline.build()[1], init, mesh=_mesh(), **kw)
    for k in a.particles:
        np.testing.assert_array_equal(a.particles[k], b.particles[k])
    assert a.log_evidence == b.log_evidence and a.n_stages == b.n_stages


def test_sharded_padding_refuses_monitored_and_sampled_sites():
    """The JAX package's two errors (mamba_tpu/model/mcmc.py:380-407), on
    a data axis of 3 that pads line's 2-vector beta and 5 observations."""
    axes = {"chains": 1, "data": 3}
    model, inputs, inits = tline.build()
    with pytest.raises(ValueError, match="monitored"):
        _pad_sharded(model, axes, {"beta": ("data",)}, inputs, inits)
    model.nodes["beta"] = __import__("dataclasses").replace(
        model.nodes["beta"], monitor=False)
    with pytest.raises(ValueError, match="sampled sites"):
        _pad_sharded(model, axes, {"beta": ("data",)}, inputs, inits)
    p_in, p_inits, masks, pads = _pad_sharded(model, axes, LINE_SPECS,
                                              inputs, inits)
    assert p_in["xmat"].shape == (6, 2) and masks["y"].sum() == 5
    assert all(d["y"].shape == (6,) for d in p_inits)
    assert pads == {"xmat": {0: 5}, "y": {0: 5}}


def test_mesh_run_matches_the_reference_mesh_run():
    """tests/test_parallel_engine.py:28-38's run, line under NUTS + Slice,
    8 chains, on the JAX package's 8-device mesh and on the port's mesh,
    at its gates for beta.  s2's posterior is near an inverse gamma of
    shape 3/2, whose variance is infinite, so its mean and standard
    deviation over 8 chains are no measure of agreement between two
    unrelated random streams; s2 is held at the same gates by its median
    and interquartile range (its quantiles over many chains:
    ``test_slice_s2_posterior_matches_the_reference`` in
    tests/test_torch_samplers_extra.py)."""
    kw = dict(iters=400, burnin=150, chains=8, seed=3, verbose=False)
    jm, jin, jinits = jline.build()
    ref = jmt.mcmc(jm, jin, jinits, mesh=jmake_mesh({"chains": 8}), **kw)
    tm, tin, tinits = tline.build()
    sim = tmt.mcmc(tm, tin, tinits, mesh=_mesh(), device="cpu", **kw)
    a, b = np.asarray(ref.value), sim.value
    beta = [ref.names.index("beta[1]"), ref.names.index("beta[2]")]
    assert list(sim.names) == list(ref.names)
    np.testing.assert_allclose(a[:, beta].mean((0, 2)), b[:, beta].mean((0, 2)),
                               rtol=0, atol=0.3)
    np.testing.assert_allclose(a[:, beta].std((0, 2)), b[:, beta].std((0, 2)),
                               rtol=0.5, atol=0.1)
    s2 = ref.names.index("s2")
    qa, qb = (np.quantile(v[:, s2], [0.25, 0.5, 0.75]) for v in (a, b))
    np.testing.assert_allclose(qa[1], qb[1], rtol=0, atol=0.3)
    np.testing.assert_allclose(qa[2] - qa[0], qb[2] - qb[0], rtol=0.5, atol=0.1)


# ---- the graft entry ----------------------------------------------------
def test_entry_is_one_gibbs_iteration():
    fn, args = entry("cpu")
    keys, state, tunes = fn(*args)
    assert keys.shape == (1, 2)
    assert state["alpha"].shape == (1, 30) and state["y"].shape == (1, 30, 5)
    assert all(torch.isfinite(v).all() for v in state.values())
    assert len(tunes) == 2


def test_dryrun_multichip_on_one_rank():
    dryrun_multichip(1, device="cpu")
