"""Gibbs blocks on captured steps (``samplers/custom.py``) on the CPU, where a
``Captured`` runs its body eagerly on its own tensors: the engine builds a
captured step only where it replays (not under ``graphs.disabled()``, not
on a data axis); the bodies of rats', the centered GLMM's and pollution's
blocks neither wait for the device nor copy from the host; the engine
through the captured step (and through the card's path emulated: warm-ups,
captures, replays) equals the same run under ``graphs.disabled()`` bit for
bit, restarts included; a ``fn`` that reads the host fails its capture
with an error that names it and the way out.  Then the blocks' draws
against the JAX package's in float64: the centered GLMM's ``s2`` draw from
the same keys (rtol 1e-12), and pollution's conjugate laws, whose samplers
differ from the JAX package's (``jax.random.gamma`` and a Cholesky factor
of the covariance there; the bounded gamma sampler and the precision's
factor here): the same normals from the same keys, and the same mean,
covariance, shape and scale.  The CUDA graphs themselves are held to the
plain steps on the card by ``chip_smoke.py``'s graphs phase."""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mamba_tpu_torch as tmt
from mamba_tpu.models import glmm as jglmm
from mamba_tpu.models import pollution as jpollution
from mamba_tpu_torch.model.mcmc import _chain_inits
from mamba_tpu_torch.model.whole import WholeValues
from mamba_tpu_torch.models import glmm, pollution, rats
from mamba_tpu_torch.ops import random as R
from mamba_tpu_torch.samplers import custom
from mamba_tpu_torch.utils import graphs
from test_torch_graphs import _HostWatch
from test_torch_graphs_zoo import _assert_same_run, _emulate_the_card

torch.set_num_threads(2)

#: the models whose schemes hold a Gibbs block, and how many each holds
GIBBS_ARMS = {"rats:nuts": 1, "glmm:centered_fused": 1, "glmm:centered": 1,
              "pollution:bhmc": 2, "pollution:bia": 2}


def _build(arm):
    name, _, scheme = arm.partition(":")
    if name == "glmm":
        model, inputs, inits, _ = glmm.build(
            G=16, n=5, seed=3, fused=scheme.endswith("fused"), centered=True)
        return model, inputs, inits
    mod = importlib.import_module(f"mamba_tpu_torch.models.{name}")
    return mod.build(scheme)


def _spy_gibbs(monkeypatch):
    """Every ``Captured`` a Gibbs block makes (``custom.drawing``)."""
    caps = []
    real = custom.drawing

    def drawing(bodies, eager=False):
        caps.append(real(bodies, eager))
        return caps[-1]
    monkeypatch.setattr(custom, "drawing", drawing)
    return caps


def _run(arm, iters=4, burnin=2, chains=3, plain=False, **kw):
    model, inputs, inits = _build(arm)
    with graphs.disabled() if plain else contextlib.nullcontext():
        return tmt.mcmc(model, inputs, inits, iters, burnin=burnin,
                        chains=chains, verbose=False, device="cpu", **kw)


# ---------------------------------------------------------------------------
# where the captured step is built
# ---------------------------------------------------------------------------

def test_gibbs_builds_a_captured_step_only_where_it_replays(monkeypatch):
    caps = _spy_gibbs(monkeypatch)
    model, inputs, inits = rats.build("nuts")
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
    spec = model.samplers[1]
    spec.build(cm)
    assert len(caps) == 1 and not caps[0].eager
    # only disabled() gives the plain step
    with graphs.disabled():
        spec.build(cm)
    assert len(caps) == 1
    # a mesh with a data axis replays, its gathers cut the body, and a
    # chain-axis-only mesh replays, as every other block does
    for axis in ("data_size", "chain_size"):
        with monkeypatch.context() as m:
            m.setattr(cm.comm, axis, 2)
            spec.build(cm)
    assert len(caps) == 3 and not any(c.eager for c in caps)


@pytest.mark.parametrize("plain", [False, True])
def test_a_value_for_a_non_block_node_raises_on_both_steps(plain):
    model, inputs, inits = rats.build("nuts")
    spec = tmt.Gibbs("s2_c", lambda key, env: {"s2_c": env["s2_c"],
                                               "mu_beta": env["mu_beta"]})
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
    with graphs.disabled() if plain else contextlib.nullcontext():
        kernel = spec.build(cm)
    state = _chain_inits(cm, inits, 2)
    with pytest.raises(ValueError, match="non-block nodes"):
        kernel.step(R.chain_keys(1, range(2)), state, (), False)


# ---------------------------------------------------------------------------
# the bodies on the device: no host sync, no copy from the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", list(GIBBS_ARMS))
def test_gibbs_bodies_neither_sync_nor_copy_from_the_host(arm, monkeypatch):
    caps = _spy_gibbs(monkeypatch)
    _run(arm, iters=2, burnin=1, chains=2, dtype=torch.float32)
    assert len(caps) == GIBBS_ARMS[arm]
    for cap in caps:
        with _HostWatch() as watch:
            cap.run()
        assert watch.seen == [], (arm, watch.seen)


def test_inverse_gamma_of_a_number_fills_on_the_device():
    keys = R.chain_keys(4, range(5))
    with _HostWatch() as watch:
        d = R.inverse_gamma_bounded(keys, 3.0, 2.0, dtype=torch.float32)
    assert watch.seen == []
    g = R.gamma_bounded(keys, 3.0, dtype=torch.float32)
    assert d.dtype == torch.float32
    assert torch.equal(d, torch.as_tensor(2.0, dtype=torch.float32) / g)


# ---------------------------------------------------------------------------
# the captured step against the plain step, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("arm", list(GIBBS_ARMS))
def test_engine_through_captured_gibbs_equals_the_plain_run(arm, card,
                                                            monkeypatch):
    caps = _spy_gibbs(monkeypatch)
    before = dict(graphs.STATS)
    with monkeypatch.context() as m:
        if card:
            _emulate_the_card(m)
        captured = _run(arm)
    plain = _run(arm, plain=True)
    assert len(caps) == GIBBS_ARMS[arm]
    _assert_same_run(captured, plain)
    if card:
        # four iterations: each block captured once, then replayed
        assert all(c.replays == 4 for c in caps)
        assert graphs.STATS["graphs"] - before["graphs"] >= GIBBS_ARMS[arm]
    else:
        assert all(c.replays == 0 and c.graphs == {} for c in caps)


@pytest.mark.parametrize("arm", ["rats:nuts", "glmm:centered_fused",
                                 "pollution:bhmc"])
def test_restart_from_the_captured_run_is_exact(arm):
    whole = _run(arm, iters=7, burnin=3, seed=5)
    part = tmt.mcmc(_run(arm, iters=5, burnin=3, seed=5), 2, verbose=False)
    np.testing.assert_array_equal(part.value, whole.value)
    for k in whole.states["state"]:
        assert torch.equal(part.states["state"][k], whole.states["state"][k]), k
    assert torch.equal(part.states["key"], whole.states["key"])


# ---------------------------------------------------------------------------
# a fn that reads the host fails its capture, naming it and the way out
# ---------------------------------------------------------------------------

class _CaptureForbids(TorchDispatchMode):
    """A capture's stand-in: the stream refuses what a CUDA graph cannot
    record (``_HostWatch.FORBIDDEN``), as a capturing stream does."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name() in _HostWatch.FORBIDDEN:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return func(*args, **(kwargs or {}))


class _Graph:
    """A graph's stand-in: its capture records under ``_CaptureForbids``."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.mode = _CaptureForbids()
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def replay(self):
        pass


class _Stream:
    def wait_stream(self, other):
        pass


def _capture_on_a_fake_card(monkeypatch):
    """``Captured._capture`` as on a card, its stream and graph stand-ins:
    the body is recorded under ``_CaptureForbids``."""
    monkeypatch.setattr(graphs.Captured, "device",
                        property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)


def test_a_fn_that_reads_the_host_fails_its_capture(monkeypatch):
    def reads_the_host(key, env):
        if float(env["mu_beta"].mean()) > 1e9:        # a host sync
            raise AssertionError
        return rats.var_gibbs(key, env)

    model, inputs, inits = rats.build("nuts")
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
    state = _chain_inits(cm, inits, 2)
    keys = R.chain_keys(1, range(2))
    variances = ["s2_c", "s2_alpha", "s2_beta"]
    with monkeypatch.context() as m:
        _capture_on_a_fake_card(m)
        good = model.samplers[1].build(cm)
        new, _ = good.step(keys, state, (), False)     # captured, no error
        assert {k for k in new if new[k] is not state[k]} == set(variances)
        bad = tmt.Gibbs(variances, reads_the_host).build(cm)
        with pytest.raises(RuntimeError, match=r"reads_the_host.*"
                           r"graphs\.disabled\(\)"):
            bad.step(keys, state, (), False)
    # its way out: the eager step
    with graphs.disabled():
        eager = tmt.Gibbs(variances, reads_the_host).build(cm)
    new, _ = eager.step(keys, state, (), False)
    ref = rats.var_gibbs(keys, WholeValues(
        cm, cm.inputs, torch.func.vmap(cm.eval_logicals)(state)))
    for k in variances:
        assert torch.equal(new[k], ref[k].to(cm.dtype))


# ---------------------------------------------------------------------------
# the draws against the JAX package's, in float64
# ---------------------------------------------------------------------------

C = 4


def _jax_keys():
    return [jax.random.key(10 + c) for c in range(C)]


def _torch_keys(jkeys):
    return torch.as_tensor(np.stack([np.asarray(jax.random.key_data(k))
                                     for k in jkeys]).astype(np.int64))


def test_centered_glmm_s2_draw_matches_the_jax_block():
    # both blocks draw s2 | b ~ IG(2 + G/2, 2 + sum(b^2)/2) with the
    # bounded gamma sampler from the chain's key: rtol 1e-12
    G = 16
    rng = np.random.default_rng(5)
    b = rng.normal(0.0, 0.7, (C, G))
    jm = jglmm.build(G=G, n=5, seed=3, centered=True)[0]
    tm = glmm.build(G=G, n=5, seed=3, centered=True)[0]
    jfn, tfn = jm.samplers[1].fn, tm.samplers[1].fn
    jkeys = _jax_keys()
    want = [float(jfn(k, {"b": jnp.asarray(b[c])})["s2"])
            for c, k in enumerate(jkeys)]
    got = tfn(_torch_keys(jkeys), {"b": torch.as_tensor(b)})["s2"]
    assert got.dtype == torch.float64 and got.shape == (C,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def _pollution_states():
    rng = np.random.default_rng(11)
    P = pollution.P
    gamma = rng.integers(0, 2, (C, P)).astype(float)
    gamma[0] = 1.0                            # every column in
    gamma[1] = 0.0                            # the intercept alone
    alpha = rng.normal(940.0, 5.0, C)
    beta = rng.normal(0.0, 20.0, (C, P))
    sigma2 = rng.uniform(800.0, 3000.0, C)
    mu = alpha[:, None] + (beta * gamma) @ pollution.X.T
    return {"y": np.broadcast_to(pollution.Y, (C, pollution.NOBS)).copy(),
            "alpha": alpha, "beta": beta, "gamma": gamma, "sigma2": sigma2,
            "mu": mu}


def _pollution_envs(states):
    jenv = [{**{k: jnp.asarray(v[c]) for k, v in states.items()},
             "X": jnp.asarray(pollution.X)} for c in range(C)]
    tenv = {**{k: torch.as_tensor(v) for k, v in states.items()},
            "X": torch.as_tensor(pollution.X)}
    return jenv, tenv


def _pollution_fns(block):
    jm = jpollution.build("bhmc")[0]
    tm = pollution.build("bhmc")[0]
    return jm.samplers[block].fn, tm.samplers[block].fn


def test_pollution_alphabeta_law_matches_the_jax_block(monkeypatch):
    # the JAX block draws mu + chol(Sigma) eps, the port mu + L^-T eps with
    # L the precision's factor (float64 on every device): the same law.
    # With eps = 0 each returns its mean, with eps = e_j its mean plus
    # column j of its square root of Sigma.  Held in posterior standard
    # deviations: means within 1e-8 of one, covariances within 1e-8 of
    # sqrt(Sigma_ii Sigma_jj)
    jfn, tfn = _pollution_fns(1)
    jenv, tenv = _pollution_envs(_pollution_states())
    jkeys = _jax_keys()
    tkeys = _torch_keys(jkeys)
    D = pollution.P + 1
    # the same normals from the same keys (1e-12 relative, as
    # test_torch_random.py holds float64 normals: the inverse error
    # functions differ in their last bits)
    jeps = np.stack([np.asarray(jax.random.normal(k, (D,), jnp.float64))
                     for k in jkeys])
    np.testing.assert_allclose(
        R.normal(tkeys, (D,), torch.float64).numpy(), jeps, rtol=1e-12)

    def joint(out):
        return np.concatenate([np.asarray(out["alpha"])[..., None],
                               np.asarray(out["beta"])], -1)

    def jax_at(eps):
        with monkeypatch.context() as m:
            m.setattr(jax.random, "normal",
                      lambda key, shape=(), dtype=None: jnp.asarray(
                          np.broadcast_to(eps, shape), dtype))
            return np.stack([joint(jfn(k, jenv[c]))
                             for c, k in enumerate(jkeys)])

    def torch_at(eps):
        with monkeypatch.context() as m:
            m.setattr(R, "normal", lambda keys, shape=(), dtype=None, **kw:
                      torch.as_tensor(eps, dtype=dtype).expand(
                          tuple(keys.shape[:-1]) + tuple(shape)).clone())
            return joint({k: v.numpy() for k, v in tfn(tkeys, tenv).items()})

    zero = np.zeros(D)
    eye = np.eye(D)
    jmean, tmean = jax_at(zero), torch_at(zero)
    jroot = np.stack([jax_at(eye[j]) - jmean for j in range(D)], -1)
    troot = np.stack([torch_at(eye[j]) - tmean for j in range(D)], -1)
    jcov = jroot @ np.swapaxes(jroot, -1, -2)
    tcov = troot @ np.swapaxes(troot, -1, -2)
    sd = np.sqrt(np.diagonal(jcov, axis1=-2, axis2=-1))
    assert np.all(sd > 0)
    np.testing.assert_array_less(np.abs(tmean - jmean) / sd, 1e-8)
    np.testing.assert_array_less(
        np.abs(tcov - jcov) / (sd[:, :, None] * sd[:, None, :]), 1e-8)
    # and the draw itself is that law's at the keys' normals
    got = joint({k: v.numpy() for k, v in tfn(tkeys, tenv).items()})
    teps = R.normal(tkeys, (D,), torch.float64).numpy()
    np.testing.assert_allclose(got, tmean + np.einsum("cij,cj->ci", troot, teps),
                               rtol=1e-12)


def test_pollution_sigma2_law_matches_the_jax_block(monkeypatch):
    # the JAX block draws InverseGamma(a, b) through jax.random.gamma, the
    # port through the bounded gamma sampler: with each gamma draw replaced
    # by 1 both return b, and each is handed the same shape a (rtol 1e-12)
    jfn, tfn = _pollution_fns(2)
    jenv, tenv = _pollution_envs(_pollution_states())
    jkeys = _jax_keys()
    shapes = {"jax": [], "torch": []}

    def jgamma(key, a, shape=None, dtype=None):
        shapes["jax"].append(float(a))
        return jnp.ones(shape, dtype)

    def tgamma(keys, a, shape=(), dtype=None, rounds=8):
        shapes["torch"].append(float(a))
        return torch.ones(tuple(keys.shape[:-1]) + tuple(shape), dtype=dtype)

    monkeypatch.setattr(jax.random, "gamma", jgamma)
    monkeypatch.setattr(R, "gamma_bounded", tgamma)
    want = [float(jfn(k, jenv[c])["sigma2"]) for c, k in enumerate(jkeys)]
    got = tfn(_torch_keys(jkeys), tenv)["sigma2"]
    assert got.dtype == torch.float64 and got.shape == (C,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(shapes["torch"], shapes["jax"][:1], rtol=1e-12)
    assert len(set(shapes["jax"])) == 1
