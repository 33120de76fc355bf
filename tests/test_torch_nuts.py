"""The port's chain-batched NUTS against the JAX package's: the
deterministic pieces exactly (checkpoint slots, leapfrog, the initial step
search given the same momentum, the dual-averaging and Welford window
arithmetic), the transitions by their statistics on a 2-D Gaussian."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_tpu.samplers import nuts as jnuts
from mamba_tpu_torch.ops import random as R
from mamba_tpu_torch.samplers import nuts as tnuts
from mamba_tpu_torch.utils import convert

torch.set_num_threads(2)

MEAN = np.array([1.0, -2.0])
SD = np.array([1.0, 2.0])


def t_logfgrad(x):
    """Batched 2-D Gaussian: (C, 2) -> ((C,), (C, 2))."""
    z = (x - torch.as_tensor(MEAN)) / torch.as_tensor(SD)
    return -0.5 * torch.sum(z * z, dim=-1), -z / torch.as_tensor(SD)


def j_logf(x):
    return -0.5 * jnp.sum(((x - MEAN) / SD) ** 2)


def j_logfgrad(x):
    return j_logf(x), jax.grad(j_logf)(x)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_ckpt_idxs_match():
    leaves = jnp.arange(1024, dtype=jnp.int32)
    jmin, jmax = jax.vmap(jnuts._ckpt_idxs)(leaves)
    got = np.array([tnuts._ckpt_idxs(int(i)) for i in range(1024)])
    np.testing.assert_array_equal(got[:, 0], np.asarray(jmin))
    np.testing.assert_array_equal(got[:, 1], np.asarray(jmax))


@pytest.mark.parametrize("with_minv", [False, True])
def test_leapfrog_matches(with_minv):
    rng = np.random.default_rng(0)
    C = 3
    x, r = rng.normal(size=(C, 2)), rng.normal(size=(C, 2))
    eps = np.array([0.1, 0.35, -0.2])
    minv = rng.uniform(0.5, 2.0, (C, 2)) if with_minv else None
    grad = t_logfgrad(_t(x))[1]
    out = tnuts._leapfrog(_t(x), _t(r), grad, _t(eps), t_logfgrad,
                          None if minv is None else _t(minv))
    for c in range(C):
        jout = jnuts._leapfrog(jnp.asarray(x[c]), jnp.asarray(r[c]),
                               j_logfgrad(jnp.asarray(x[c]))[1], eps[c],
                               j_logfgrad,
                               None if minv is None else jnp.asarray(minv[c]))
        for t_part, j_part in zip(out, jout):
            np.testing.assert_allclose(t_part[c].numpy(), np.asarray(j_part),
                                       rtol=1e-12, atol=1e-14)


def test_nutsepsilon_matches_given_the_same_momentum():
    C = 4
    x = np.random.default_rng(1).normal(0, 3, (C, 2))
    keys = [jax.random.key(10 + c) for c in range(C)]
    # the JAX search draws r0 from its key; hand the same r0 to the port
    r0 = np.stack([np.asarray(jax.random.normal(k, (2,), jnp.float64))
                   for k in keys])
    j_eps = [float(jnuts.nutsepsilon(k, jnp.asarray(x[c]), j_logfgrad))
             for c, k in enumerate(keys)]
    t_eps = tnuts._epsilon_search(_t(x), _t(r0), t_logfgrad)
    np.testing.assert_allclose(t_eps.numpy(), j_eps, rtol=1e-12)


def _jax_tunes(C, dim):
    """Per-chain JAX tunes in distinct adaptation states: mid-window, at a
    window boundary, entering adaptation (m == 0), and without a mass."""
    rng = np.random.default_rng(4)
    tunes = []
    for c in range(C):
        t = jnuts.nuts_init(None, jnp.zeros(dim), j_logfgrad, epsilon=0.4,
                            mass_window=4)
        t = t._replace(
            epsilon=jnp.asarray(rng.uniform(0.1, 1.0)),
            epsilonbar=jnp.asarray(rng.uniform(0.1, 1.0)),
            Hbar=jnp.asarray(rng.normal(0, 0.1)), mu=jnp.asarray(rng.normal()),
            m=jnp.asarray([5, 7, 0, 3][c], jnp.int32),
            minv=jnp.asarray(rng.uniform(0.5, 2.0, dim)),
            w_n=jnp.asarray([1, 3, 0, 2][c], jnp.int32),
            w_mean=jnp.asarray(rng.normal(size=dim)),
            w_m2=jnp.asarray(rng.uniform(0.5, 3.0, dim)),
            window=jnp.asarray([4, 4, 8, 0][c], jnp.int32))
        tunes.append(t)
    return tunes


@pytest.mark.parametrize("adapt", [True, False])
def test_adaptation_arithmetic_matches(adapt, monkeypatch):
    C, dim = 4, 2
    rng = np.random.default_rng(9)
    x2 = rng.normal(size=(C, dim))
    alpha = rng.uniform(0.5, 7.0, C)
    nalpha = np.array([7, 3, 1, 15], np.int32)
    depth = np.array([3, 2, 1, 4], np.int32)
    j_tunes = _jax_tunes(C, dim)
    stacked = {f: np.stack([np.asarray(getattr(t, f)) for t in j_tunes])
               for f in jnuts.NUTSTune._fields}
    t_tune = convert.nuts_tune(stacked, "cpu", torch.float64)

    # the transition itself is replaced by fixed outputs on both sides, so
    # only the step-size and mass arithmetic around it is compared
    monkeypatch.setattr(tnuts, "nuts_sub", lambda *a, **k: (
        _t(x2), _t(alpha), torch.as_tensor(nalpha), torch.as_tensor(depth)))
    _, new_t = tnuts.nuts_step(None, _t(np.zeros((C, dim))), t_tune,
                               t_logfgrad, adapt)
    for c in range(C):
        monkeypatch.setattr(jnuts, "nuts_sub", lambda *a, c=c, **k: (
            jnp.asarray(x2[c]), jnp.asarray(alpha[c]),
            jnp.asarray(nalpha[c]), jnp.asarray(depth[c])))
        _, new_j = jnuts.nuts_step(jax.random.key(0), jnp.zeros(dim),
                                   j_tunes[c], j_logfgrad, adapt)
        for f in jnuts.NUTSTune._fields:
            np.testing.assert_allclose(
                getattr(new_t, f)[c].numpy(), np.asarray(getattr(new_j, f)),
                rtol=1e-12, err_msg=f"chain {c}, field {f}")
        assert bool(new_t.adapted[c]) == (adapt or bool(j_tunes[c].epsilonbar != 1.0))


def test_frozen_phase_uses_epsilonbar_even_when_it_is_one(monkeypatch):
    # the JAX package tests "adapted ever" as epsilonbar != 1.0; the port
    # keeps an explicit flag, so an averaged step of exactly 1.0 is still used
    tune = tnuts.nuts_init(None, torch.zeros(1, 2, dtype=torch.float64),
                           t_logfgrad, epsilon=0.25)
    tune = tune._replace(epsilonbar=torch.ones(1, dtype=torch.float64),
                         adapted=torch.ones(1, dtype=torch.bool))
    seen = []
    monkeypatch.setattr(tnuts, "nuts_sub", lambda gen, x, eps, *a, **k: (
        seen.append(eps.clone()) or (x, eps, torch.ones(1, dtype=torch.int32),
                                     torch.ones(1, dtype=torch.int32))))
    tnuts.nuts_step(None, torch.zeros(1, 2, dtype=torch.float64), tune,
                    t_logfgrad, adapt=False)
    assert seen[0].item() == 1.0


def _run(C, n, adapt_iters, target=0.6, seed=0):
    keys = R.chain_keys(seed, range(C))
    x = torch.zeros(C, 2, dtype=torch.float64)
    tune = tnuts.nuts_init(keys, x, t_logfgrad, target=target)
    assert (tune.epsilon > 0).all()
    xs, accept = [], []
    for i in range(n):
        x, tune = tnuts.nuts_step(R.fold_in(keys, i), x, tune, t_logfgrad,
                                  adapt=i < adapt_iters)
        xs.append(x)
        accept.append(tune.alpha / tune.nalpha.clamp(min=1))
    return torch.stack(xs).numpy(), torch.stack(accept).numpy(), tune


def test_batched_nuts_targets_gaussian():
    xs, _, tune = _run(C=8, n=700, adapt_iters=200)
    kept = xs[200:].reshape(-1, 2)
    np.testing.assert_allclose(kept.mean(0), MEAN, atol=0.25)
    np.testing.assert_allclose(kept.std(0), SD, atol=0.35)
    assert ((tune.epsilon > 0.05) & (tune.epsilon < 10.0)).all()


def test_batched_nuts_adapt_targets_accept_rate():
    # the accept statistic of one transition is noisy; its mean over the
    # late adaptation iterations of every chain moves to the target
    _, accept, _ = _run(C=4, n=300, adapt_iters=300, target=0.8, seed=2)
    late = accept[150:].mean(0)
    assert ((late > 0.65) & (late <= 0.95)).all(), late
