"""The port's keyed random numbers (``mamba_tpu_torch/ops/random.py``) held to
``jax.random`` and the JAX package's ``ops/rng.py`` on the CPU.

``key``, ``fold_in``, ``split``, 32- and 64-bit ``bits`` and float32 and
float64 ``uniform`` on [0, 1) equal ``jax.random``'s bit for bit (on
another range within one ulp of its span: XLA fuses the scaling into an
FMA; exponentials and Gumbels, whose logs differ, within 1e-13).  A normal is
``sqrt(2) erfinv(u)`` of a uniform that is bit-identical to JAX's; the two
packages' ``erfinv`` differ (XLA's polynomial is within 86 float32 ulp and
454 float64 ulp of the exact value, torch's within 2 and 3), so the normals
agree with JAX's within a relative 1e-5 (float32) and 1e-12 (float64), and
with the exact ``sqrt(2) erfinv`` of the same uniform within 2 ulp
(float32) and 4 ulp (float64).  ``gamma_bounded`` follows from those
normals: relative 2e-5 (float32) and 1e-12 (float64) of the JAX package's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special, stats

import mamba_tpu as jmt
import mamba_tpu_torch as tmt
from mamba_tpu.models import rats as jrats
from mamba_tpu.ops import rng as jrng
from mamba_tpu_torch.models import rats as trats
from mamba_tpu_torch.ops import fused_glmm as tfg
from mamba_tpu_torch.ops import random as R

SEEDS = [0, 7, 123, 2**31 - 1, 2**40 + 5]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    jk, tk = jax.random.key(seed), R.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _kd(jk))
    for d in (0, 1, 5, 2**32 - 1):
        np.testing.assert_array_equal(R.fold_in(tk, d).numpy(),
                                      _kd(jax.random.fold_in(jk, d)))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(R.split(tk, n).numpy(),
                                      _kd(jax.random.split(jk, n)))
    # chain keys, batched fold_in and split
    idx = np.arange(5)
    jchain = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(idx))
    tchain = R.chain_keys(seed, idx)
    np.testing.assert_array_equal(tchain.numpy(), _kd(jchain))
    np.testing.assert_array_equal(
        R.split(tchain, 3).numpy(),
        _kd(jax.vmap(lambda k: jax.random.split(k, 3), out_axes=1)(jchain)))
    data = torch.tensor([3, 1, 4, 1, 5])
    np.testing.assert_array_equal(
        R.fold_in(tchain, data).numpy(),
        _kd(jax.vmap(jax.random.fold_in)(jchain, jnp.asarray(data.numpy()))))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 3, 5)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_and_uniforms_equal_jax_bit_for_bit(seed, shape):
    jk, tk = jax.random.key(seed), R.key(seed)
    np.testing.assert_array_equal(
        R.bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(
        R.bits(tk, shape, 64).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint64)).view(np.int64))
    for jdt, tdt in DTYPES:
        np.testing.assert_array_equal(
            R.uniform(tk, shape, tdt).numpy(),
            np.asarray(jax.random.uniform(jk, shape, jdt)))
        # a range other than [0, 1): XLA fuses u * span + lo into one FMA,
        # the port rounds twice; within one ulp of the span
        np.testing.assert_allclose(
            R.uniform(tk, shape, tdt, -2.5, 3.0).numpy(),
            np.asarray(jax.random.uniform(jk, shape, jdt, -2.5, 3.0)), rtol=0,
            atol=np.spacing(np.array(5.5, R.uniform(tk, (), tdt).numpy().dtype)))


@pytest.mark.parametrize("jdt,tdt,rel,ulps", [
    (jnp.float32, torch.float32, 1e-5, 2),
    (jnp.float64, torch.float64, 1e-12, 4)])
def test_normals_agree_with_jax_and_with_the_exact_erfinv(jdt, tdt, rel, ulps):
    jk, tk = jax.random.key(11), R.key(11)
    n = 200_000
    t = R.normal(tk, (n,), tdt).numpy()
    j = np.asarray(jax.random.normal(jk, (n,), jdt))
    np.testing.assert_allclose(t, j, rtol=rel, atol=rel * 1e-3)
    lo = np.nextafter(np.array(-1.0, t.dtype), np.array(0.0, t.dtype))
    u = R.uniform(tk, (n,), tdt, float(lo), 1.0).numpy()
    exact = np.sqrt(2.0) * special.erfinv(u.astype(np.float64))
    spacing = np.spacing(np.maximum(np.abs(exact), 1e-3).astype(t.dtype))
    assert (np.abs(t - exact) / spacing).max() <= ulps


def test_exponential_gumbel_and_categorical_follow_jax():
    jk, tk = jax.random.key(3), R.key(3)
    np.testing.assert_allclose(
        R.exponential(tk, (1000,), torch.float64).numpy(),
        np.asarray(jax.random.exponential(jk, (1000,), jnp.float64)),
        rtol=1e-13)
    np.testing.assert_allclose(
        R.gumbel(tk, (1000,), torch.float64).numpy(),
        np.asarray(jax.random.gumbel(jk, (1000,), jnp.float64)), rtol=1e-13)
    logits = np.log(np.random.default_rng(0).dirichlet(np.ones(6), 400))
    np.testing.assert_array_equal(
        R.categorical(tk, torch.tensor(logits)).numpy(),
        np.asarray(jax.random.categorical(jk, jnp.asarray(logits))))


@pytest.mark.parametrize("a", [0.3, 1.0, 2.5, 75.001])
@pytest.mark.parametrize("jdt,tdt,rtol", [
    (jnp.float32, torch.float32, 2e-5), (jnp.float64, torch.float64, 1e-12)])
def test_gamma_bounded_matches_the_jax_package(a, jdt, tdt, rtol):
    jk, tk = jax.random.key(5), R.key(5)
    j = np.asarray(jrng.gamma_bounded(jk, jnp.full((3000,), a, jdt)))
    t = R.gamma_bounded(tk, torch.full((3000,), a, dtype=tdt)).numpy()
    np.testing.assert_allclose(t, j, rtol=rtol)
    # a shape in front, as the JAX function takes it
    j2 = np.asarray(jrng.gamma_bounded(jk, jnp.asarray([a, 2 * a], jdt), (40,)))
    t2 = R.gamma_bounded(tk, torch.tensor([a, 2 * a], dtype=tdt), (40,))
    np.testing.assert_allclose(t2.numpy(), j2, rtol=rtol)


def test_inverse_gamma_bounded_matches_the_jax_package_per_chain():
    keys = R.chain_keys(9, range(6))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(
        jnp.arange(6))
    a = np.array([0.5, 2.0, 3.0, 40.0, 75.001, 15.001])
    b = np.array([2.0, 1.0, 0.3, 80.0, 2700.0, 5.0])
    t = R.inverse_gamma_bounded(keys, torch.tensor(a), torch.tensor(b))
    j = jax.vmap(jrng.inverse_gamma_bounded)(jkeys, jnp.asarray(a),
                                              jnp.asarray(b))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)


@pytest.mark.parametrize("a", [0.3, 0.75, 1.0, 2.5, 15.05, 75.001, 5000.0])
def test_gamma_bounded_ks(a):
    # tests/test_rng.py's cases, on the port's sampler
    x = R.gamma_bounded(R.key(1), torch.tensor(a, dtype=torch.float64),
                        (60_000,)).numpy()
    assert (x > 0).all()
    _, p = stats.kstest(x, "gamma", args=(a,))
    assert p > 1e-4, (a, p)


def test_inverse_gamma_bounded_conjugate_shape():
    a, b = 75.001, 2700.0
    y = R.inverse_gamma_bounded(R.key(3), torch.tensor(a, dtype=torch.float64),
                                b, (120_000,)).numpy()
    np.testing.assert_allclose(y.mean(), b / (a - 1.0), rtol=0.01)
    np.testing.assert_allclose(y.std(), b / (a - 1.0) / np.sqrt(a - 2.0),
                               rtol=0.05)


def _chi2_p(x, pmf, support):
    obs = np.array([(x == k).sum() for k in support])
    exp = pmf(support) * len(x)
    keep = exp > 5
    chi = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    # the tail outside the kept cells, pooled into one cell
    rest_o, rest_e = len(x) - obs[keep].sum(), len(x) - exp[keep].sum()
    if rest_e > 5:
        chi += (rest_o - rest_e) ** 2 / rest_e
        keep = np.append(keep, True)
    return stats.chi2.sf(chi, max(int(keep.sum()) - 1, 1))


@pytest.mark.parametrize("lam", [0.05, 0.8, 4.0, 9.99, 10.0, 37.5, 1000.0])
def test_poisson_chi2(lam):
    x = R.poisson(R.key(2), torch.full((40_000,), lam, dtype=torch.float64))
    x = x.numpy()
    assert np.isfinite(x).all() and (x == np.round(x)).all()
    hi = int(lam + 8 * np.sqrt(lam) + 10)
    assert _chi2_p(x, lambda k: stats.poisson.pmf(k, lam),
                   np.arange(hi + 1)) > 1e-4


@pytest.mark.parametrize("n,p", [(1, 0.3), (5, 0.3), (40, 0.02), (100, 0.05),
                                 (100, 0.5), (1000, 0.9), (30, 0.99), (0, 0.4)])
def test_binomial_chi2(n, p):
    x = R.binomial(R.key(4), torch.full((40_000,), float(n), dtype=torch.float64),
                   torch.full((40_000,), p, dtype=torch.float64)).numpy()
    assert ((x >= 0) & (x <= n)).all() and (x == np.round(x)).all()
    assert _chi2_p(x, lambda k: stats.binom.pmf(k, n, p),
                   np.arange(n + 1)) > 1e-4


def test_draws_fall_back_to_the_mode_when_every_round_misses(monkeypatch):
    # uniforms of 1 - 2**-53 miss every rejection round; the draws stay
    # finite at the mode
    monkeypatch.setattr(R, "uniform", lambda k, shape, dtype, *a, **kw:
                        torch.full(tuple(k.shape[:-1]) + tuple(shape),
                                   1.0 - 2.0**-53, dtype=dtype))
    lam = torch.tensor([12.5, 400.0], dtype=torch.float64)
    np.testing.assert_array_equal(R.poisson(R.key(0), lam).numpy(), [12, 400])
    x = R.binomial(R.key(0), torch.tensor([200.0]), torch.tensor([0.3],
                                                                 dtype=torch.float64))
    np.testing.assert_array_equal(x.numpy(), [60])


def _every_draw(keys):
    """One of each draw, at per-key shapes, from ``keys``."""
    K = tuple(keys.shape[:-1])
    f = dict(dtype=torch.float64)
    a = torch.linspace(0.4, 30.0, 12, **f).reshape(3, 4).expand(K + (3, 4))
    return {
        "bits": R.bits(keys, (3, 4)),
        "uniform": R.uniform(keys, (3, 4), torch.float32, fold=5),
        "normal": R.normal(keys, (2, 6), torch.float64),
        "gamma": R.gamma_bounded(keys, a),
        "poisson": R.poisson(keys, a),
        "binomial": R.binomial(keys, torch.full_like(a, 50.0), a / 31.0),
        "categorical": R.categorical(keys, torch.log(a)),
        "split": R.split(keys, 3).movedim(0, -2),
    }


def test_a_chain_batched_draw_is_each_chain_s_own_draw():
    keys = R.chain_keys(17, range(5))
    batched = _every_draw(keys)
    for c in range(5):
        alone = _every_draw(keys[c])
        for name, v in batched.items():
            np.testing.assert_array_equal(v[c].numpy(), alone[name].numpy(),
                                          err_msg=name)


def test_a_draw_at_a_rank_s_counters_is_its_slice_of_the_whole_draw():
    keys = R.chain_keys(3, range(4))
    index = torch.tensor([7, 0, 3, 12])
    whole = R.normal(keys, (2, 13), torch.float64)
    part = R.normal(keys, (2, 13), torch.float64, index=index)
    np.testing.assert_array_equal(part.numpy(), whole[..., index].numpy())
    u = R.uniform(keys, (13,), torch.float32, fold=2, index=index)
    np.testing.assert_array_equal(
        u.numpy(), R.uniform(keys, (13,), torch.float32, fold=2)[:, index].numpy())


def test_fold_as_a_tensor_equals_fold_in_then_draw():
    keys = R.chain_keys(5, range(3))
    for fold in (4, torch.tensor([4]), torch.tensor([4, 4, 4])):
        np.testing.assert_array_equal(
            R.uniform(keys, (6,), torch.float64, fold=fold).numpy(),
            R.uniform(R.fold_in(keys, 4), (6,), torch.float64).numpy())


def test_keys_lead_says_where_a_batch_of_keys_sits():
    # four keys and a batch of four: the shapes fit both places, and
    # keys_lead decides; without it the parameters' place is taken
    from mamba_tpu_torch.ops.distributions.base import keys_lead
    keys = R.chain_keys(9, range(4))
    d = tmt.Normal(torch.zeros(4, dtype=torch.float64), 1.0)
    with keys_lead("draw"):          # row c from key c, a draw of d
        drawn = d.sample(keys, (4,))
    for c in range(4):
        np.testing.assert_array_equal(drawn[c].numpy(),
                                      d.sample(keys[c], ()).numpy())
    with keys_lead("params"):        # column c from key c, element c's draws
        stacked = d.sample(keys, (4,))
    for c in range(4):
        np.testing.assert_array_equal(
            stacked[:, c].numpy(),
            tmt.Normal(torch.zeros((), dtype=torch.float64), 1.0).sample(
                keys[c], (4,)).numpy())
    np.testing.assert_array_equal(d.sample(keys, (4,)).numpy(),
                                  stacked.numpy())
    with keys_lead("params"), pytest.raises(ValueError, match="lead the params"):
        tmt.Normal(0.0, 1.0).sample(keys, (4,))


def test_rats_final_keys_equal_the_jax_run_s():
    # the same seed, the same two blocks (NUTS, then the variances' Gibbs
    # block): every chain's key after the run is the JAX run's
    jmodel, jinputs, jinits = jrats.build("nuts")
    jsim = jmt.mcmc(jmodel, jinputs, jinits, 3, burnin=1, chains=2, seed=31,
                    verbose=False)
    model, inputs, inits = trats.build("nuts")
    sim = tmt.mcmc(model, inputs, inits, 3, burnin=1, chains=2, seed=31,
                   verbose=False, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(sim.states["key"].numpy(),
                                  _kd(jsim.states["key"]))


def test_keys_on_a_device_the_kernel_does_not_take_raise():
    keys = torch.zeros((3, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        R.uniform(keys, (4,))
    with pytest.raises(TypeError, match="int64"):
        R.uniform(torch.zeros((3, 2), dtype=torch.int32), (4,))


def test_cuda_keys_never_take_the_plain_version(monkeypatch, tmp_path):
    # CUDA keys go to the kernel's library; without a compiler and without a
    # library built earlier that fails, and nothing falls back
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(R, "threefry_plain", lambda *a, **k: pytest.fail(
        "CUDA keys reached the plain version"))
    monkeypatch.setattr(tfg.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(R, "_lib_path", lambda: tmp_path / "libthreefry.so")
    monkeypatch.setattr(R, "_lib", functools.cache(R._lib.__wrapped__))
    before = R.threefry_draw.launches
    with FakeTensorMode():
        keys = torch.empty((4, 2), dtype=torch.int64, device="cuda")
        for draw in (lambda: R.uniform(keys, (3,)), lambda: R.split(keys),
                     lambda: R.fold_in(keys, 2)):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                draw()
    assert R.threefry_draw.launches == before
