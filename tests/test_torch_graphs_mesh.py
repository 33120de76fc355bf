"""Split blocks on captured steps: on a mesh's data axis a captured body is
cut at each collective over the data group (``utils.graphs.cut``), as
GSPMD compiles the all-reduces and all-gathers into the JAX package's
program (mamba_tpu/model/mcmc.py:344-460), and the collectives run between
the segments' replays.

Two gloo ranks of a (1, 2) chains x data mesh (this file run as a script,
started by ``parallel.launch.run_ranks``, once for every test), float64,
the card emulated on the CPU (``tests/_torch_card.py``: warm-ups that issue
their collectives, a capture that issues none, replays that run the
segments and the cuts in turn):

1. a segmented ``Captured`` on its own, a body with two ``data_sum`` calls
   and a ``gather_data``: the collectives issued per phase, the segments,
   the replays equal to the body run eagerly bit for bit, and a
   collective that changes its shape at a replay, or in the capture,
   raises;
2. engine runs through the emulated card against ``graphs.disabled()``
   runs, bit for bit and equal on both ranks: rats under NUTS with its
   Gibbs block (y, alpha and beta named), the GLMM under ChEES (y, xt and
   z named; and with only its data named), line on six points whose tau
   prior reads ss, gathered per density call, line under its AMWG + Slice
   scheme, mice (MISS) and line on six points under ABC;
3. each rank's block density and gradient completed over the group inside
   an emulated segmented capture, against the JAX package's compiled
   density at the same state (1e-10): rats' NUTS block, the fused GLMM
   with only its data named, and line's block gathered per call.

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
from mamba_tpu_torch.models import glmm as tglmm, line as tline
from mamba_tpu_torch.models import mice as tmice, rats as trats
from mamba_tpu_torch.parallel.launch import run_ranks
from mamba_tpu_torch.parallel.mesh import MeshComm, make_mesh
from mamba_tpu_torch.utils import graphs

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_card import _emulate_the_card, _Replaying  # noqa: E402
from test_torch_local_views import LINE6_SPECS, _line_ss_tau  # noqa: E402

torch.set_num_threads(2)

#: seconds the ranks may take, and a collective may wait
RANKS_TIMEOUT, GROUP_TIMEOUT = 240, 60
RATS_SPECS = {"y": ("data",), "alpha": ("data",), "beta": ("data",)}
RATS_BLOCK = ("alpha", "beta", "mu_alpha", "mu_beta")
GLMM_LOCAL = {"y": (None, "data"), "xt": (None, None, "data"), "z": ("data",)}
GLMM_DATA = {"y": (None, "data"), "xt": (None, None, "data")}
GLMM_BLOCK = ("beta", "z", "s2")
LINE_SPECS = {"y": ("data",), "xmat": ("data", None)}
MICE_SPECS = {"t": (None, "data"), "tcensor": (None, "data")}
G, C = 16, 3


# ---------------------------------------------------------------------------
# 1. a segmented Captured on its own
# ---------------------------------------------------------------------------

def _phase() -> str:
    """Where a collective is issued: a warm-up, the capture, a replay, or
    outside any ``Captured``."""
    if graphs._CAPTURING:
        return ("replay" if isinstance(graphs._CAPTURING[-1], _Replaying)
                else "capture")
    return "warm_up" if graphs._WARMING else "eager"


class _Counted:
    """``torch.distributed``'s all-reduce and all-gather, each call logged
    with its phase."""

    def __init__(self, mp):
        self.log = []
        for name in ("all_reduce", "all_gather"):
            inner = getattr(dist, name)

            def issue(*a, _inner=inner, _name=name, **k):
                self.log.append((_name, _phase()))
                return _inner(*a, **k)
            mp.setattr(dist, name, issue)

    def count(self, phase):
        return sum(p == phase for _, p in self.log)


def _body(comm, b, s):
    """Two sums over the data group and one gather of a whole value."""
    x = b["x"]
    (a,) = comm.data_sum(torch.sum(x * s["w"], dim=-1))
    whole = comm.gather_data(x + a[:, None], 1)
    q, r = comm.data_sum(torch.sum(whole * whole, dim=-1), torch.sum(x, -1))
    x.add_(1e-3 * (q - r)[:, None] * s["w"])
    b["n"].add_(1)
    return a


def _loaded(cap, rank):
    rng = np.random.default_rng(10 + rank)
    cap.load(x=torch.as_tensor(rng.normal(size=(C, 4))),
             n=torch.zeros((), dtype=torch.int64))
    cap.load_state({"w": torch.as_tensor(rng.uniform(0.5, 2.0, (C, 4)))})
    return cap


def _mode_segments(rank, mesh):
    comm = MeshComm(mesh)
    runs = 5
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _emulate_the_card(mp)
        counted = _Counted(mp)
        before = dict(graphs.STATS)
        cap = _loaded(graphs.Captured(lambda b, s: _body(comm, b, s)), rank)
        a = cap.run(runs)
        delta = {k: graphs.STATS[k] - before[k] for k in before}
        out["issued"] = json.dumps({p: counted.count(p) for p in
                                    ("warm_up", "capture", "replay")})
        out["segments"] = len(cap.graphs["body"].segments)
        out["cuts"] = json.dumps([c.kind for c in cap.graphs["body"].cuts])
        out["stats"] = json.dumps({k: delta[k] for k in
                                   ("graphs", "replays", "collectives")})
        out["x"], out["n"], out["a"] = (cap.bufs["x"].numpy(),
                                        int(cap.bufs["n"]), a.numpy())
    eager = _loaded(graphs.Captured(lambda b, s: _body(comm, b, s),
                                    eager=True), rank)
    out["eager_a"] = eager.run(runs).numpy()
    out["eager_x"], out["eager_n"] = (eager.bufs["x"].numpy(),
                                      int(eager.bufs["n"]))
    out["refusals"] = json.dumps([_refusal(comm, rank, at)
                                  for at in ("replay", "capture")])
    return out


def _refusal(comm, rank, at):
    """The error of a body whose gather narrows at its first replay
    (``at="replay"``: the fourth run, after two warm-ups and the capture)
    or in its capture."""
    runs = []

    def shifty(b, s):
        runs.append(1)
        narrow = (len(runs) == 4) if at == "replay" else graphs.capturing()
        comm.gather_data(b["x"][:, :2] if narrow else b["x"], 1)
        b["n"].add_(1)

    with pytest.MonkeyPatch.context() as mp:
        _emulate_the_card(mp)
        cap = _loaded(graphs.Captured(shifty), rank)
        try:
            cap.run(2)
        except RuntimeError as e:
            return str(e)
    return ""


def test_a_segmented_capture_cuts_at_each_collective(ranks):
    """The emulated capture issues no collective, each warm-up three and
    each replay three (two all-reduces and an all-gather), between four
    segments; the replays equal the body run eagerly, bit for bit, on
    each rank; a collective that changes its shape at a replay, or in the
    capture against the warm-ups, raises on both ranks."""
    for res in ranks:
        assert json.loads(str(res["issued"])) == {
            "warm_up": 6, "capture": 0, "replay": 15}
        assert int(res["segments"]) == 4
        assert json.loads(str(res["cuts"])) == ["all_reduce", "all_gather",
                                                "all_reduce"]
        assert json.loads(str(res["stats"])) == {
            "graphs": 4, "replays": 20, "collectives": 15}
        np.testing.assert_array_equal(res["x"], res["eager_x"])
        np.testing.assert_array_equal(res["a"], res["eager_a"])
        assert int(res["n"]) == int(res["eager_n"]) == 5
        replay, capture = json.loads(str(res["refusals"]))
        assert "collective changed" in replay, replay
        assert "where the warm-up issued" in capture, capture
    # the sums over the group agree; each rank keeps its own slice
    np.testing.assert_array_equal(ranks[0]["a"], ranks[1]["a"])
    assert not np.array_equal(ranks[0]["x"], ranks[1]["x"])


# ---------------------------------------------------------------------------
# 2. engine runs: the emulated card against graphs.disabled()
# ---------------------------------------------------------------------------

def _rats():
    return trats.build("nuts")


def _glmm_chees():
    model, inputs, inits, _ = tglmm.build(G=G, n=5, seed=3, fused=True)
    model.set_samplers([tmt.ChEESHMC(GLMM_BLOCK, max_steps=16,
                                     mass_window=2)])
    return model, inputs, inits


def _line_slice():
    return tline.build(scheme="amwg_slice")


def _line6_abc():
    """line on six points (the data axis divides them) under ABC on beta
    and Slice on s2: the zoo's line_abc draws y as one MvNormal event of
    five points, which a data rank cannot hold in part."""
    import math
    model = tmt.Model(
        y=tmt.Stochastic(1, lambda mu, s2: tmt.Normal(mu, torch.sqrt(s2)),
                         monitor=False),
        mu=tmt.Logical(1, lambda xmat, beta: xmat @ beta, monitor=False),
        beta=tmt.Stochastic(1, lambda: tmt.Normal(torch.zeros(2),
                                                  math.sqrt(1000.0))),
        s2=tmt.Stochastic(lambda: tmt.InverseGamma(0.001, 0.001)))
    model.set_samplers([tmt.ABC("beta", 0.3, lambda v: v, 1.0,
                                kernel="normal", maxdraw=60, nsim=2),
                        tmt.Slice("s2", 3.0)])
    inputs = {"xmat": np.stack([np.ones(6), np.arange(1.0, 7.0)], 1)}
    y = np.array([1.0, 3.0, 3.0, 3.0, 5.0, 6.0])
    inits = [{"y": y, "beta": np.array([0.5, 0.7]), "s2": 1.5}]
    return model, inputs, inits


def _line_ss():
    model, inputs, init, _ = _line_ss_tau(tmt)
    return model, inputs, [init]


#: name: (build, site_specs, iterations, burnin)
ARMS = {"rats": (_rats, RATS_SPECS, 4, 2),
        "glmm_chees": (_glmm_chees, GLMM_LOCAL, 4, 2),
        "glmm_data": (_glmm_chees, GLMM_DATA, 4, 2),
        "line_ss_tau": (_line_ss, LINE6_SPECS, 6, 3),
        "line_slice": (_line_slice, LINE_SPECS, 6, 3),
        "mice": (tmice.build, MICE_SPECS, 4, 2),
        "line_abc": (_line6_abc, LINE_SPECS, 6, 3)}


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


def _arm(name, mesh, plain):
    build, specs, iters, burnin = ARMS[name]
    model, inputs, inits = build()
    before = dict(graphs.STATS)
    if plain:
        with graphs.disabled():
            sim = tmt.mcmc(model, inputs, inits, iters, burnin=burnin,
                           chains=C, seed=5, device="cpu", verbose=False,
                           mesh=mesh, site_specs=specs)
    else:
        sim = tmt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=C,
                       seed=5, device="cpu", verbose=False, mesh=mesh,
                       site_specs=specs)
    st = sim.states
    out = {"value": sim.value, "tunes": _flat_tunes(st["tunes"]),
           "key": st["key"].numpy(),
           **{f"state_{k}": v.numpy() for k, v in st["state"].items()}}
    out["counts"] = np.array([graphs.STATS[k] - before[k] for k in
                              ("graphs", "replays", "collectives")])
    return out


def _mode_arms(rank, mesh):
    out = {}
    for name in ARMS:
        with pytest.MonkeyPatch.context() as mp:
            _emulate_the_card(mp)
            card = _arm(name, mesh, False)
        plain = _arm(name, mesh, True)
        out.update({f"{name}:card:{k}": v for k, v in card.items()})
        out.update({f"{name}:plain:{k}": v for k, v in plain.items()})
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_on_a_data_axis_replays_equal_to_the_plain_loops(ranks, arm):
    """Every block on the data axis took its captured step (graphs
    captured, segments replayed, collectives run between them), and the
    draws, tunes, keys and final state equal the plain loops' bit for bit
    and, gathered, the other rank's."""
    r0, r1 = ranks
    keys = [k for k in r0 if k.startswith(f"{arm}:card:")
            and not k.endswith(":counts")]
    assert keys
    for res in (r0, r1):
        graphs_, replays, collectives = res[f"{arm}:card:counts"]
        assert graphs_ > 0 and replays >= graphs_ and collectives > 0, arm
        assert res[f"{arm}:plain:counts"].tolist() == [0, 0, 0]
        for k in keys:
            np.testing.assert_array_equal(
                res[k], res[k.replace(":card:", ":plain:")], err_msg=k)
    # the draws, gathered whole, and the keys; a rank's slices and its
    # coordinates' tunes are its own
    for k in (f"{arm}:card:value", f"{arm}:card:key"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert np.isfinite(r0[f"{arm}:card:value"]).all()


# ---------------------------------------------------------------------------
# 3. the completed density inside a segmented capture, against the JAX one
# ---------------------------------------------------------------------------

def _rats_case(pkg):
    model, inputs, inits = pkg.models.rats.build("nuts")
    return model, inputs, inits[0]


def _glmm_case(pkg):
    model, inputs, inits, _ = pkg.models.glmm.build(G=G, n=5, seed=3,
                                                    fused=True)
    return model, inputs, inits[0]


def _line_ss_case(pkg):
    return _line_ss_tau(pkg)[:3]


#: name: (build, site_specs, block, the cuts of one density call)
PARITY = {"rats": (_rats_case, RATS_SPECS, RATS_BLOCK, ["all_reduce"]),
          "glmm_fused_data": (_glmm_case, GLMM_DATA, GLMM_BLOCK,
                              ["all_reduce"]),
          "line_ss_tau": (_line_ss_case, LINE6_SPECS, ("beta", "s2", "tau"),
                          ["all_gather", "all_reduce", "all_reduce"])}


def _states(init):
    """C chains around ``init``: each sampled site moved by a standard
    normal step (variances by a factor), the data as they are."""
    rng = np.random.default_rng(5)
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


def _mode_parity(rank, mesh):
    out = {}
    for name, (build, specs, block, _) in PARITY.items():
        model, inputs, init = build(tmt)
        cm = tmt.compile_model(model, inputs, init, device="cpu",
                               comm=MeshComm(mesh), site_specs=specs)
        state = cm.cut_state({k: torch.as_tensor(v)
                              for k, v in _states(init).items()})
        state = cm.block_prepare(block)(state)
        density = cm.block_density(block, True, grad=True)
        x = cm.block_maps(block, True)[0](state)

        def body(b, s, density=density):
            v, g = density(b["x"], s)
            b["v"].copy_(v)
            b["g"].copy_(g)

        with pytest.MonkeyPatch.context() as mp:
            _emulate_the_card(mp)
            cap = graphs.Captured(body)
            cap.load(x=x, v=torch.zeros(C, dtype=x.dtype),
                     g=torch.zeros_like(x))
            cap.load_state(state)
            cap.run(2)
            prog = cap.graphs["body"]
        coords = cm.block_coords(block)
        out[f"{name}_v"], out[f"{name}_g"] = (cap.bufs["v"].numpy(),
                                              cap.bufs["g"].numpy())
        out[f"{name}_index"] = (np.arange(x.shape[1]) if coords.index is None
                                else coords.index.numpy())
        out[f"{name}_cuts"] = json.dumps([c.kind for c in prog.cuts])
    return out


@pytest.mark.parametrize("case", list(PARITY))
def test_the_completed_density_in_a_capture_matches_the_jax_package(ranks,
                                                                    case):
    """Each rank's block density and gradient, completed over the data
    group between the segments of an emulated capture (rats, and the fused
    GLMM with only its data named, whose y reads its slice of the whole b:
    the density's all-reduce; line's beta block whose tau prior reads ss,
    gathered per density call: the all-gather of ss's parents, the
    all-reduce of the gradient in them, then the density's all-reduce,
    with the vjp of the rank's slice between them), against
    the JAX package's compiled block density and gradient at the same
    state, at the rank's coordinates (1e-10)."""
    import jax
    import mamba_tpu as jmt
    build, _, block, cuts = PARITY[case]
    model, inputs, init = build(jmt)
    np_state = _states(init)
    jcm = jmt.compile_model(model, inputs, init)
    jpack, _, _, jlogf = jcm.block_functions(block, True)
    want_v, want_g = [], []
    for c in range(C):
        jst = {k: np.asarray(a[c]) for k, a in np_state.items()}
        jv, jg = jax.value_and_grad(jlogf)(jpack(jst), jst)
        want_v.append(float(jv))
        want_g.append(np.asarray(jg))
    want_v, want_g = np.array(want_v), np.stack(want_g)
    scale = np.abs(want_g).max()
    for res in ranks:
        assert json.loads(str(res[f"{case}_cuts"])) == cuts
        np.testing.assert_allclose(res[f"{case}_v"], want_v, rtol=1e-10)
        np.testing.assert_allclose(res[f"{case}_g"],
                                   want_g[:, res[f"{case}_index"]],
                                   rtol=1e-10, atol=1e-10 * scale)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

MODES = {"segments": _mode_segments, "arms": _mode_arms,
         "parity": _mode_parity}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of every mode, from one launch."""
    tmp = tmp_path_factory.mktemp("graphs_mesh")
    env = dict(os.environ, MULTIPROC_OUT=str(tmp))
    run_ranks(lambda r, init: [sys.executable, __file__, init, 2, r], 2,
              timeout=RANKS_TIMEOUT, env=env)
    return [dict(np.load(tmp / f"ranks{r}.npz")) for r in range(2)]


def _main(argv) -> int:
    from mamba_tpu_torch.parallel import distributed_init
    init, n, rank = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    distributed_init(init, n, rank, device_type="cpu", timeout=GROUP_TIMEOUT)
    try:
        mesh = make_mesh({"chains": 1, "data": n}, "cpu")
        out = {}
        for mode in MODES.values():
            out.update(mode(rank, mesh))
        np.savez(Path(os.environ["MULTIPROC_OUT"]) / f"ranks{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
