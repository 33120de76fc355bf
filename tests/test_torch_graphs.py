"""The engine's captured steps (``mamba_tpu_torch/utils/graphs.py``) on the
CPU, where nothing is captured and every body runs eagerly on the same
tensors: the device-side NUTS bookkeeping against the JAX package's traced
forms, the leaf step and the ChEES leapfrog step replayed against the plain
loops they replace, bit for bit, and the engine with its captured steps
against the engine without them.  The CUDA graphs themselves are held to
the plain loops on the card by ``chip_smoke.py``'s graphs phase."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mamba_tpu.samplers import nuts as jnuts
import mamba_tpu_torch as tmt
from mamba_tpu_torch.models import glmm, rats
from mamba_tpu_torch.parallel.mesh import WHOLE, BlockCoords
from mamba_tpu_torch.samplers import chees as tchees
from mamba_tpu_torch.samplers import dgs as tdgs
from mamba_tpu_torch.samplers import nuts as tnuts
from mamba_tpu_torch.utils import graphs

torch.set_num_threads(2)

MAX_DEPTH = 10
F64 = dict(dtype=torch.float64)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_ckpt_idxs_tensor_form_matches_the_traced_jax_form():
    leaves = np.arange(1024, dtype=np.int32)
    jmin, jmax = jax.vmap(jnuts._ckpt_idxs)(jnp.asarray(leaves))
    tmin, tmax = tnuts._ckpt_idxs_t(torch.as_tensor(leaves))
    assert tmin.dtype == torch.int32
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))


def _turned_inputs(C, dim, seed):
    rng = np.random.default_rng(seed)
    leaves = rng.integers(1, 1024, C) | 1            # odd leaves close subtrees
    idx = np.array([tnuts._ckpt_idxs(int(leaf)) for leaf in leaves], np.int32)
    return (rng.normal(size=(C, MAX_DEPTH, dim)), rng.normal(size=(C, MAX_DEPTH, dim)),
            rng.normal(size=(C, dim)), rng.normal(size=(C, dim)),
            rng.choice([-1.0, 1.0], C), idx[:, 0], idx[:, 1],
            rng.uniform(0.2, 3.0, (C, dim)))


@pytest.mark.parametrize("with_minv", [False, True])
def test_slot_mask_subtree_turned_matches_the_jax_slot_loop(with_minv):
    C, dim = 64, 5
    x_ck, r_ck, x, r, pm, imin, imax, minv = _turned_inputs(C, dim, 3)
    m = minv if with_minv else None
    j_turned = jax.vmap(
        lambda a, b, c, d, e, f, g, h: jnuts._subtree_turned(
            a, b, c, d, e, f, g, MAX_DEPTH, h),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0 if with_minv else None))(
        x_ck, r_ck, x, r, pm, jnp.asarray(imin), jnp.asarray(imax),
        None if m is None else jnp.asarray(m))
    t_turned = tnuts._subtree_turned_slots(
        _t(x_ck), _t(r_ck), _t(x), _t(r), _t(pm),
        torch.as_tensor(imin)[:, None], torch.as_tensor(imax)[:, None],
        None if m is None else _t(m))
    np.testing.assert_array_equal(t_turned.numpy(), np.asarray(j_turned))
    # both outcomes occur, and the host-index form agrees chain by chain
    assert 0 < int(t_turned.sum()) < C
    for c in range(C):
        one = tnuts._turned(*WHOLE.sums(*tnuts._turn_terms(
            _t(x_ck[c:c + 1]), _t(r_ck[c:c + 1]), _t(x[c:c + 1]), _t(r[c:c + 1]),
            _t(pm[c:c + 1]), int(imin[c]), int(imax[c]),
            None if m is None else _t(m[c:c + 1]))))
        assert bool(one[0]) == bool(t_turned[c])


def _gaussian_density(x, state):
    """Batched Gaussian with per-chain precisions ``state["prec"]``."""
    prec = state["prec"]
    return -0.5 * torch.sum(prec * x * x, dim=-1), -prec * x


#: leaf-step cases: each chain's step size, and which chains take part
LEAF_CASES = {
    "all_active": dict(eps=(0.2, 0.6), inactive=0.0),
    "some_inactive": dict(eps=(0.2, 0.6), inactive=0.4),
    # large steps turn within a level; steps past the stability limit of
    # the leapfrog (eps * sqrt(prec) > 2) diverge
    "diverge_or_turn": dict(eps=(0.05, 4.0), inactive=0.2),
}


def _level_inputs(case, j, C=16, dim=7, seed=0):
    rng = np.random.default_rng(seed + 17 * j)
    spec = LEAF_CASES[case]
    state = {"prec": _t(rng.uniform(0.5, 4.0, (C, dim)))}
    x0 = _t(rng.normal(size=(C, dim)))
    minv = _t(rng.uniform(0.5, 2.0, (C, dim)))
    r0 = _t(rng.normal(size=(C, dim))) / torch.sqrt(minv)
    logf0, grad0 = _gaussian_density(x0, state)
    logp0 = logf0 - tnuts._kinetic(r0, minv)
    logu0 = logp0 + torch.log(_t(rng.uniform(size=C)))
    eps = _t(rng.uniform(*spec["eps"], C))
    pm = _t(rng.choice([-1.0, 1.0], C))
    active = torch.as_tensor(rng.uniform(size=C) >= spec["inactive"])
    us = _t(rng.uniform(size=(2 ** j, C)))
    ck = (_t(rng.normal(size=(C, MAX_DEPTH, dim))),
          _t(rng.normal(size=(C, MAX_DEPTH, dim))))
    return state, (x0, r0, grad0, pm, j, eps, None, logp0, logu0), ck, minv, active, us


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_leaf_step_replayed_equals_the_plain_subtree_loop(case):
    graphed = tnuts.GraphedSubtree(_gaussian_density, MAX_DEPTH)
    stopped_mid_level = 0
    for j in range(6):
        state, head, (xck, rck), minv, active, us = _level_inputs(case, j)
        logfgrad = lambda x, state=state: _gaussian_density(x, state)  # noqa: E731
        args = list(head)
        args[6] = logfgrad
        # the plain loop's checkpoint slots start from other values than the
        # leaf step's own: a level writes every slot before it reads it
        plain = tnuts._build_subtree(*args, xck, rck, minv, active, us)
        graphed.load_state(state)
        got = graphed(*args, None, None, minv, active, us)
        for name, p, g in zip(tnuts._LEAF_OUT, plain, got):
            assert p.dtype == g.dtype and torch.equal(p, g), (case, j, name)
        nalpha, sprime = plain[7], plain[5]
        if case != "all_active":
            assert (nalpha[~active] == 0).all()
        stopped_mid_level += int(((nalpha > 0) & (nalpha < 2 ** j) & ~sprime).sum())
    if case == "diverge_or_turn":
        assert stopped_mid_level > 0
    assert graphed.cap.graphs == {}         # nothing is captured on the CPU


def test_leaf_step_cases_diverge_and_turn():
    # the mid-level stops of the diverge_or_turn case include both kinds
    state, head, (xck, rck), minv, active, us = _level_inputs("diverge_or_turn", 5)
    args = list(head)
    args[6] = lambda x: _gaussian_density(x, state)
    out = tnuts._build_subtree(*args, xck, rck, minv, active, us)
    nprime, sprime, nalpha = out[4], out[5], out[7]
    stopped = active & ~sprime & (nalpha < 32)
    assert (stopped & (nprime == 0) & (nalpha <= 2)).any()     # diverged at once
    assert (stopped & (nprime > 2)).any()                      # turned later


@pytest.mark.parametrize("L", [1, 3, 17])
def test_chees_leapfrog_replayed_equals_the_loop(L):
    rng = np.random.default_rng(L)
    C, dim = 12, 5
    state = {"prec": _t(rng.uniform(0.5, 4.0, (C, dim)))}
    x = _t(rng.normal(size=(C, dim)))
    p = _t(rng.normal(size=(C, dim)))
    logf, grad = _gaussian_density(x, state)
    eps = torch.tensor(0.31, **F64)
    minv = _t(rng.uniform(0.5, 2.0, dim))
    plain = tchees._trajectory(x, p, logf, grad, eps, minv, L,
                               lambda y: _gaussian_density(y, state))
    traj = tchees.GraphedTrajectory(_gaussian_density)
    traj.load_state(state)
    got = traj(x, p, logf, grad, eps, minv, L, None)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)
    assert traj.cap.replays == 0 and traj.cap.graphs == {}


def _rats_run(iters, burnin, chains=6, **kw):
    model, inputs, inits = rats.build("nuts")
    return tmt.mcmc(model, inputs, inits, iters, burnin=burnin, chains=chains,
                    verbose=False, device="cpu", **kw)


def _depths(monkeypatch):
    seen = []
    inner = tnuts.nuts_sub

    def recording(*a, **k):
        out = inner(*a, **k)
        seen.append(out[3].clone())
        return out
    monkeypatch.setattr(tnuts, "nuts_sub", recording)
    return seen


def _assert_tunes_equal(ta, tb):
    """Every block's tune equal, field by field (a Gibbs block's is ())."""
    assert len(ta) == len(tb)
    for a, b in zip(ta, tb):
        assert type(a) is type(b) and len(a) == len(b)
        for f, u, v in zip(getattr(a, "_fields", range(len(a))), a, b):
            if isinstance(u, torch.Tensor):
                assert torch.equal(u, v), f
            else:
                assert u == v, f


def test_engine_leaf_steps_equal_the_plain_nuts_step(monkeypatch):
    before = dict(graphs.STATS)
    depths = _depths(monkeypatch)
    sim = _rats_run(5, 3)
    with graphs.disabled():
        plain = _rats_run(5, 3)
    assert graphs.enabled()
    half = len(depths) // 2
    assert half == 5 and all(torch.equal(a, b) for a, b in
                             zip(depths[:half], depths[half:]))
    assert max(int(d.max()) for d in depths) >= 3
    np.testing.assert_array_equal(sim.value, plain.value)
    _assert_tunes_equal(sim.states["tunes"], plain.states["tunes"])
    for k in sim.states["state"]:
        assert torch.equal(sim.states["state"][k], plain.states["state"][k])
    assert graphs.STATS == before            # no capture, no replay on the CPU
    assert set(sim.timing) == {"setup_s", "sample_s", "fetch_s"}


def test_engine_restart_through_the_leaf_steps_is_exact():
    whole = _rats_run(9, 3, chains=4, seed=5)
    part = tmt.mcmc(_rats_run(6, 3, chains=4, seed=5), 3, verbose=False)
    np.testing.assert_array_equal(part.value, whole.value)
    _assert_tunes_equal(part.states["tunes"], whole.states["tunes"])


def _glmm_chees(**kw):
    model, inputs, inits, _ = glmm.build(G=24, n=5, seed=3, fused=True)
    model.set_samplers([tmt.ChEESHMC(model.samplers[0].params, max_steps=64,
                                     mass_window=3), *model.samplers[1:]])
    return tmt.mcmc(model, inputs, inits, 8, burnin=4, chains=6,
                    verbose=False, device="cpu", **kw)


def test_engine_chees_trajectory_equals_the_plain_loop(monkeypatch):
    steps = []
    inner = tchees._steps
    monkeypatch.setattr(tchees, "_steps", lambda *a: steps.append(inner(*a)) or steps[-1])
    sim = _glmm_chees()
    with graphs.disabled():
        plain = _glmm_chees()
    assert steps[:8] == steps[8:] and max(steps) > 1
    np.testing.assert_array_equal(sim.value, plain.value)
    _assert_tunes_equal(sim.states["tunes"], plain.states["tunes"])


def test_split_blocks_and_disabled_builds_take_the_plain_loop(monkeypatch):
    model, inputs, inits = rats.build("nuts")
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
    made = []
    real = tnuts.GraphedSubtree
    monkeypatch.setattr(tnuts, "GraphedSubtree",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    spec = model.samplers[0]
    spec.build(cm)
    assert len(made) == 1
    # only disabled() gives the plain loop
    with graphs.disabled():
        spec.build(cm)
    assert len(made) == 1
    # a block split over a data axis replays too, its leaf summing over the
    # block's coordinates
    coords = BlockCoords()
    monkeypatch.setattr(cm, "block_split", lambda *a, **k: True)
    monkeypatch.setattr(cm, "block_coords", lambda *a, **k: coords)
    spec.build(cm)
    assert len(made) == 2 and made[-1][2] is coords


class _HostWatch(TorchDispatchMode):
    """Records the operators that wait for the device or copy data from
    the host, neither of which a CUDA graph can capture."""

    #: ``aten::multinomial`` checks its probabilities on the host before
    #: it draws
    FORBIDDEN = ("aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
                 "aten::nonzero", "aten::lift_fresh", "aten::lift_fresh_copy",
                 "aten::multinomial")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name() in self.FORBIDDEN:
            self.seen.append(func.name())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arm", ["rats:nuts", "birats", "lsat:nuts",
                                 "glmm_nuts", "glmm_chees"])
def test_captured_bodies_neither_sync_nor_copy_from_the_host(arm, monkeypatch):
    # rats and the GLMM are the bench's arms; birats' covariance goes
    # through the CholeskyPD bijector and lsat's through a truncation bound
    bodies = []
    for cls in (tnuts.GraphedSubtree, tchees.GraphedTrajectory):
        real_call = cls.__call__

        def spy(self, *a, real_call=real_call):
            bodies.append(self.cap)
            return real_call(self, *a)
        monkeypatch.setattr(cls, "__call__", spy)
    if ":" in arm or arm == "birats":
        name, _, scheme = arm.partition(":")
        mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
        model, inputs, inits = mod.build(scheme) if scheme else mod.build()
        tmt.mcmc(model, inputs, inits, 2, burnin=1, chains=2, verbose=False,
                 device="cpu", dtype=torch.float32)
    elif arm == "glmm_chees":
        _glmm_chees()
    else:
        model, inputs, inits, _ = glmm.build(G=16, n=5, seed=3, fused=True)
        tmt.mcmc(model, inputs, inits, 2, burnin=1, chains=3, verbose=False,
                 device="cpu")
    cap = bodies[-1]
    with _HostWatch() as watch:
        cap.run(2)
    assert watch.seen == []


def test_count_launch_counts_captured_launches_per_replay():
    def kernel():
        graphs.count_launch(kernel)
    kernel.launches = 0
    kernel()
    assert kernel.launches == 1 and not graphs.capturing()
    tally = {}
    graphs._CAPTURING.append(tally)
    try:
        assert graphs.capturing()
        kernel()
        kernel()
    finally:
        graphs._CAPTURING.pop()
    assert kernel.launches == 1 and tally == {kernel: 2}


def test_captured_buffers_keep_their_tensors_until_a_layout_changes():
    cap = graphs.Captured(lambda b, state: b["x"].add_(state["k"]))
    x = torch.zeros(3, **F64)
    cap.load(x=x)
    held = cap.bufs["x"]
    k = torch.ones(3, **F64)
    cap.load_state({"k": k})
    out = cap.run(6)
    assert out is held and torch.equal(held, torch.full((3,), 6.0, **F64))
    assert torch.equal(x, torch.zeros(3, **F64))     # the caller's is untouched
    k.fill_(2.0)                      # the same tensor again is not copied
    cap.load_state({"k": k})
    assert torch.equal(cap.state["k"], torch.ones(3, **F64))
    cap.graphs["body"] = (None, None, {})      # as if captured
    cap.load(x=torch.zeros(3, **F64))
    assert cap.bufs["x"] is held and cap.graphs
    cap.load(x=torch.zeros(4, **F64))
    assert cap.bufs["x"] is not held and cap.graphs == {}


def test_captured_steps_go_with_their_kernel_without_the_collector():
    # a captured step holds its graphs' memory pool on the card: nothing
    # may keep it alive in a reference cycle after the run that built it
    import gc
    import weakref
    gc.disable()
    try:
        steps = [tnuts.GraphedSubtree(_gaussian_density, MAX_DEPTH),
                 tchees.GraphedTrajectory(_gaussian_density)]
        refs = [weakref.ref(s.cap) for s in steps]
        del steps
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_graphed_sweep_runs_the_sweep_eagerly_on_the_cpu():
    sweep = lambda x, noise, state: x + noise.sum(-1) * state["w"]  # noqa: E731
    gs = tdgs.GraphedSweep(sweep)
    x = torch.arange(6, **F64).reshape(2, 3)
    noise = torch.ones(2, 3, 4, **F64)
    state = {"w": torch.full((2, 1), 0.5, **F64)}
    out = gs(x, noise, state)
    assert torch.equal(out, sweep(x, noise, state))
    out.fill_(0.0)                                   # a clone, not the buffer
    assert torch.equal(gs(x, noise, state), sweep(x, noise, state))
