"""The port's AMM and MISS samplers, ``forward_sample`` and the engine's NaN
inits against the JAX package's.

AMM: the two packages draw different streams, so the JAX step's draws are
reproduced per chain from its key (two normal vectors and one uniform, its
three-way split) and handed to the port's batched step in the order the
port draws them; states and tunes (through ``utils.convert``) then agree to
rtol 1e-9 in float64, step after step, across the switch to the adaptive
mixture (the same arithmetic, but the Cholesky factors of the empirical
covariance come from two libraries, and their last bits feed the next
proposals).  MISS, ``forward_sample`` and the imputation of NaN inits draw from
the chains' own keys, so they are held to their contracts: observed entries
bit-identical, exactly the masked ones redrawn inside their support, missing
lead dims drawn iid, one imputation per chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_tpu_torch as tmt
from mamba_tpu_torch.ops import random as R
from mamba_tpu.samplers import amm as jamm
from mamba_tpu_torch.model.mcmc import _chain_inits
from mamba_tpu_torch.models import glmm as tglmm
from mamba_tpu_torch.models import mice as tmice
from mamba_tpu_torch.samplers import amm as tamm
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

RTOL = 1e-9
MEAN = np.array([1.0, -2.0, 0.5])
SD = np.array([0.3, 1.5, 0.8])
C, DIM = 5, 3
# a small fixed proposal: most moves are accepted, so the points a chain has
# visited soon span the space and its empirical covariance is full rank
SIGMA = 0.05 * np.array([[0.5, 0.1, 0.0], [0.1, 0.4, 0.05], [0.0, 0.05, 0.3]])


def j_logf(x):
    return -0.5 * jnp.sum(((x - MEAN) / SD) ** 2)


def t_logf(x):
    z = (x - torch.as_tensor(MEAN)) / torch.as_tensor(SD)
    return -0.5 * torch.sum(z * z, dim=-1)


def _jax_draws(key):
    """The draws ``jamm.amm_step`` makes from ``key``."""
    k1, k2, ka = jax.random.split(key, 3)
    return (np.asarray(jax.random.normal(k1, (DIM,), jnp.float64)),
            np.asarray(jax.random.normal(k2, (DIM,), jnp.float64)),
            np.asarray(jax.random.uniform(ka, (), jnp.float64)))


def _feed(monkeypatch, randn, rand):
    """``ops.random.normal`` / ``uniform`` hand out the given arrays in
    order, each checked against the shape asked for (chain first)."""
    queues = {"randn": list(randn), "rand": list(rand)}

    def feeder(kind):
        def draw(key, shape=(), dtype=torch.float64, *a, index=None, **k):
            full = tuple(key.shape[:-1]) + R._out_shape(shape, index)
            v = queues[kind].pop(0)
            assert v.shape == full, (kind, v.shape, full)
            return torch.as_tensor(v, dtype=dtype)
        return draw

    monkeypatch.setattr(R, "normal", feeder("randn"))
    monkeypatch.setattr(R, "uniform", feeder("rand"))
    return queues


def _stack(tunes):
    """Per-chain JAX tunes -> numpy fields with the chain axis first."""
    return {k: np.stack([np.asarray(getattr(t, k)) for t in tunes])
            for k in jamm.AMMTune._fields}


def _assert_tunes_match(ttune, jtunes, step):
    """Fields agree; the adaptive factor is compared for the chains whose
    empirical covariance is well conditioned (with fewer visited points than
    dimensions it is singular up to rounding, and whether a Cholesky of it
    fails is then a matter of the last bit)."""
    got, want = convert.tune_to_numpy(ttune), _stack(jtunes)
    for k in ("SigmaL", "Mv", "Mvv"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-14,
                                   err_msg=f"{k} at step {step}")
    cov = want["Mvv"] - np.einsum("ci,cj->cij", want["Mv"], want["Mv"])
    eig = np.linalg.eigvalsh(cov)
    well = eig[:, 0] > 1e-8 * np.maximum(eig[:, -1], 1e-300)
    np.testing.assert_allclose(got["SigmaLm"][well], want["SigmaLm"][well],
                               rtol=1e-9, atol=1e-11,
                               err_msg=f"SigmaLm at step {step}")
    np.testing.assert_array_equal(got["m"], want["m"])
    assert got["beta"] == want["beta"][0] and got["scale"] == want["scale"][0]


@pytest.mark.parametrize("adapt", [True, False])
def test_amm_steps_match_given_the_same_draws(monkeypatch, adapt):
    x0 = np.random.default_rng(0).normal(0.0, 1.0, (C, DIM))
    jx = [jnp.asarray(r) for r in x0]
    jt = [jamm.amm_init(r, SIGMA) for r in jx]
    tx = torch.as_tensor(x0)
    tt = convert.amm_tune(_stack(jt), "cpu", torch.float64)
    _assert_tunes_match(tamm.amm_init(tx, SIGMA), jt, 0)
    _assert_tunes_match(tt, jt, 0)

    mixed = False
    for step in range(1, 13):           # the mixture starts after 2 * DIM
        keys = [jax.random.key(100 * step + c) for c in range(C)]
        draws = [_jax_draws(k) for k in keys]
        out = [jamm.amm_step(k, x, t, j_logf, jnp.asarray(adapt))
               for k, x, t in zip(keys, jx, jt)]
        jx, jt = [o[0] for o in out], [o[1] for o in out]
        with monkeypatch.context() as m:
            q = _feed(m, [np.stack([d[0] for d in draws]),
                          np.stack([d[1] for d in draws])],
                      [np.stack([d[2] for d in draws])])
            tx, tt = tamm.amm_step(R.chain_keys(0, range(C)), tx, tt, t_logf, adapt)
            assert not q["randn"] and not q["rand"]
        np.testing.assert_allclose(tx.numpy(), np.stack(jx), rtol=RTOL,
                                   err_msg=f"x at step {step}")
        _assert_tunes_match(tt, jt, step)
        mixed = mixed or bool((tt.m > 2 * DIM).any())
    assert mixed == adapt
    if adapt:       # by the end every chain proposes from its own factor
        assert (np.abs(convert.tune_to_numpy(tt)["SigmaLm"]).sum((1, 2)) > 0).all()
    assert tt.m.dtype == torch.int32 and tt.m.shape == (C,)


def test_amm_proposal_from_given_normals():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(C, DIM)))
    L = np.linalg.cholesky(SIGMA)
    Lm = np.linalg.cholesky(SIGMA + 0.2 * np.eye(DIM))
    tune = tamm.amm_init(x, SIGMA)._replace(
        SigmaLm=torch.as_tensor(Lm).expand(C, DIM, DIM).clone(),
        m=torch.tensor([0, 6, 7, 8, 100], dtype=torch.int32))
    z, zm = rng.normal(size=(C, DIM)), rng.normal(size=(C, DIM))
    y = tamm.amm_propose(x, tune, torch.as_tensor(z), torch.as_tensor(zm))
    fixed = x.numpy() + z @ L.T
    mix = x.numpy() + 0.05 * (z @ L.T) + 0.95 * (zm @ Lm.T)
    want = np.where((np.array([0, 6, 7, 8, 100]) > 2 * DIM)[:, None], mix, fixed)
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL)


def test_amm_keeps_the_factor_of_a_chain_whose_covariance_is_singular():
    # chains 0 and 2 have moments of one repeated point (zero empirical
    # covariance after the update); chains 1 and 3 have proper moments.
    # The JAX step's Cholesky gives NaN there and keeps the old factor;
    # the port's cholesky_ex reports those chains and keeps theirs.
    rng = np.random.default_rng(2)
    x2 = rng.normal(size=(4, DIM))
    old = np.linalg.cholesky(SIGMA)
    Mv = x2.copy()
    Mvv = np.einsum("ci,cj->cij", x2, x2)
    Mvv[1] += np.eye(DIM)
    Mvv[3] += 2.0 * np.eye(DIM)
    fields = dict(SigmaL=np.broadcast_to(old, (4, DIM, DIM)),
                  SigmaLm=np.broadcast_to(0.5 * old, (4, DIM, DIM)),
                  Mv=Mv, Mvv=Mvv, m=np.full(4, 9, np.int32),
                  beta=np.full(4, 0.05), scale=np.full(4, 2.38))
    tt = tamm.amm_adapt(torch.as_tensor(x2),
                        convert.amm_tune(fields, "cpu", torch.float64))
    got = convert.tune_to_numpy(tt)
    np.testing.assert_array_equal(got["SigmaLm"][0], 0.5 * old)
    np.testing.assert_array_equal(got["SigmaLm"][2], 0.5 * old)
    assert not np.allclose(got["SigmaLm"][1], 0.5 * old)
    assert np.isfinite(got["SigmaLm"]).all()

    # the JAX step with a proposal that is always rejected leaves x2 as it
    # is, so its adaptation sees the same moments
    for c in range(4):
        jt = jamm.AMMTune(**{k: jnp.asarray(v[c]) for k, v in fields.items()
                             if k not in ("beta", "scale")},
                          beta=0.05, scale=2.38)
        _, jt2 = jamm.amm_step(jax.random.key(c), jnp.asarray(x2[c]), jt,
                               lambda y, c=c: jnp.where(
                                   jnp.all(y == x2[c]), 0.0, -jnp.inf),
                               jnp.asarray(True))
        np.testing.assert_allclose(got["SigmaLm"][c], np.asarray(jt2.SigmaLm),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got["Mvv"][c], np.asarray(jt2.Mvv), rtol=RTOL)


def test_amm_tune_round_trip():
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(C, DIM)))
    t0 = tamm.amm_adapt(x + 0.1, tamm.amm_init(x, SIGMA))
    t1 = convert.amm_tune(convert.tune_to_numpy(t0), "cpu", torch.float64)
    for a, b in zip(t0, t1):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    bad = convert.tune_to_numpy(t0)
    bad["beta"] = np.array([0.05, 0.06, 0.05, 0.05, 0.05])
    with pytest.raises(ValueError, match="differs across chains"):
        convert.amm_tune(bad, "cpu", torch.float64)


# ---------------------------------------------------------------------------
# MISS, forward_sample, NaN inits
# ---------------------------------------------------------------------------

def _mice(chains=6):
    model, inputs, inits = tmice.build()
    cm = tmt.compile_model(model, inputs, inits[0], device="cpu")
    return cm, _chain_inits(cm, inits, chains)


def test_nan_inits_are_imputed_per_chain():
    cm, state = _mice()
    t = state["t"]
    mask = torch.as_tensor(np.isnan(tmice.T))
    assert torch.isfinite(t).all()
    obs = torch.as_tensor(tmice.T)[~mask]
    for c in range(t.shape[0]):
        assert torch.equal(t[c][~mask], obs)        # data: bit-identical
    imputed = t[:, mask]                            # (chains, n_missing)
    assert (imputed > torch.as_tensor(tmice.TCENSOR)[mask]).all()
    # one draw per chain and entry, never one draw copied
    assert len(torch.unique(imputed)) == imputed.numel()
    assert torch.isfinite(torch.func.vmap(cm.logpdf)(state)).all()


def test_miss_redraws_exactly_the_masked_entries():
    cm, state = _mice()
    kernel = tmt.MISS("t").build(cm)
    gen = R.chain_keys(1, range(state["t"].shape[0]))
    tune = kernel.init(gen, state)
    new, _ = kernel.step(gen, state, tune, True)
    mask = torch.as_tensor(np.isnan(tmice.T))
    assert torch.equal(new["t"][:, ~mask], state["t"][:, ~mask])
    assert (new["t"][:, mask] != state["t"][:, mask]).all()
    assert (new["t"][:, mask] > torch.as_tensor(tmice.TCENSOR)[mask]).all()
    for k in ("beta", "r"):
        assert new[k] is state[k]
    assert tmt.samplers.missing_masks(cm, ("t", "r")).keys() == {"t"}


def test_fused_glmm_with_nan_data_still_refuses():
    model, inputs, inits, _ = tglmm.build(G=8, n=10, seed=0, fused=True)
    y = np.array(inits[0]["y"], dtype=float)
    y[0, 0] = np.nan
    bad = [dict(i, y=y) for i in inits]
    with pytest.raises(ValueError, match="fused=False"):
        tmt.mcmc(model, inputs, bad, 4, burnin=2, chains=2, verbose=False,
                 device="cpu")


def _toy():
    model = tmt.Model(
        s=tmt.Stochastic(lambda: tmt.Gamma(2.0, 1.0)),
        a=tmt.Stochastic(1, lambda s: tmt.Normal(0.0, s)),          # (7,) iid
        b=tmt.Stochastic(2, lambda a: tmt.Normal(a, 0.01)),         # (3, 7)
        p=tmt.Stochastic(1, lambda s: tmt.dists.Mixed(
            tmt.Normal(s, 1.0), tmt.Uniform(0.0, 1.0), tmt.Poisson(3.0))),
    )
    inits = {"s": 1.0, "a": np.zeros(7), "b": np.zeros((3, 7)),
             "p": np.array([0.0, 0.5, 1.0])}
    return tmt.compile_model(model, {}, inits, device="cpu"), inits


def test_forward_sample_draws_missing_lead_dims_iid():
    cm, inits = _toy()
    chains = 4
    state = _chain_inits(cm, inits, chains)
    gen = R.chain_keys(0, range(chains))
    out = cm.forward_sample(gen, state)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "s": (chains,), "a": (chains, 7), "b": (chains, 3, 7),
        "p": (chains, 3)}
    assert all(v.dtype == torch.float64 for v in out.values())
    # a scalar-parameter Normal over a (7,) node: 7 different draws a chain
    assert len(torch.unique(out["a"])) == chains * 7
    # a (7,) batch under a (3, 7) node: the 3 lead rows are drawn iid around
    # the same means, never one row copied
    assert len(torch.unique(out["b"])) == chains * 21
    assert torch.allclose(out["b"], out["a"][:, None, :].expand(-1, 3, -1),
                          atol=0.1)
    # ancestral order: a is drawn at the new s
    assert (out["a"].abs().amax(dim=1) < 6 * out["s"]).all()
    assert cm.example_dists["p"].in_support(out["p"]).all()
    # each chain's draws are its own key's, the Mixed node's unstacked
    # elements too: the run of that chain alone
    for c in range(chains):
        one = cm.forward_sample(gen[c:c + 1],
                                {k: v[c:c + 1] for k, v in state.items()})
        for k, v in out.items():
            assert torch.equal(v[c], one[k][0]), (k, c)
    # names restrict what is redrawn
    only = cm.forward_sample(gen, state, names=("a",))
    assert only["s"] is state["s"] and not torch.equal(only["a"], state["a"])


def test_forward_sample_follows_the_model_in_distribution():
    from scipy import stats
    cm, inits = _toy()
    state = _chain_inits(cm, inits, 4000)
    out = cm.forward_sample(R.chain_keys(2, range(4000)), state)
    assert stats.kstest(out["s"].numpy(), stats.gamma(2.0).cdf).pvalue > 1e-3
    z = (out["a"] / out["s"][:, None]).numpy().ravel()
    assert stats.kstest(z, stats.norm.cdf).pvalue > 1e-3
    assert abs(out["p"][:, 2].mean().item() - 3.0) < 0.15


def test_node_dist_is_the_distribution_of_one_chain():
    cm, inits = _toy()
    state = {k: v[0] for k, v in _chain_inits(cm, inits, 1).items()}
    d = cm.node_dist("a", dict(state, s=torch.tensor(2.5, dtype=torch.float64)))
    assert isinstance(d, tmt.Normal) and float(d.sigma) == 2.5
    stacked = cm.stacked_node_dist("b", _chain_inits(cm, inits, 3))
    assert tuple(stacked.mu.shape) == (3, 7)
