"""Counter-based random numbers keyed per chain: threefry2x32 as the JAX
package draws it.

Counterpart of ``jax.random`` as the JAX package uses it (under
``jax_threefry_partitionable``, jax 0.9's default) and of its
``ops/rng.py``.  A key is an int64 tensor ``(..., 2)`` holding two uint32
words; its leading dims are a batch of keys (``(C, 2)``: one per chain).
Every function takes a batch of keys and draws each key's numbers at the
per-key ``shape``: the result is ``keys.shape[:-1] + shape``, and row ``c``
equals the same call on key ``c`` alone.  So a chain's numbers depend on
its key only, never on how many chains share a device or a rank.

- ``key(seed)`` is ``(seed >> 32, seed & 0xffffffff)``;
- ``fold_in(k, d)`` is threefry2x32 of ``k`` at the counter ``(0, d)``;
- ``split(k, n)[i]`` is ``fold_in(k, i)``;
- element ``i`` of a draw (row-major over ``shape``) hashes the counter
  ``(i >> 32, i & 0xffffffff)`` into ``(b1, b2)``; 32-bit bits are
  ``b1 ^ b2``, 64-bit bits ``b1 << 32 | b2``;
- a float32 (float64) uniform puts the top 23 (52) bits in the mantissa of
  a number in [1, 2) and subtracts 1; a normal is ``sqrt(2) erfinv(u)``, u
  uniform on [nextafter(-1, 0), 1).

A draw can be asked for at a list of counters (``index``): the per-key
draw of ``shape`` cut to ``index`` along its last dim, computed only there.
A data rank draws its coordinates of a momentum that way, as GSPMD does
with partitionable threefry.  ``fold=`` draws from ``fold_in(keys, fold)``
in the same launch; ``fold`` may be a device tensor (a round counter that a
captured body advances in place).

``gamma_bounded``, ``inverse_gamma_bounded``, ``poisson`` and ``binomial``
run a fixed number of rounds with no loop that depends on the data, so a
CUDA graph captures them: Marsaglia-Tsang with 8 rounds (the JAX package's
``ops/rng.py``), and for Poisson and binomial inversion over 41 terms below
a mean of 10 and Hormann's transformed rejection (PTRS, BTRS) with 16
rounds above it, each with a miss probability below 1e-10 and the mode as
its finite fallback.

On a CUDA device every draw, ``split`` and ``fold_in`` is one launch of the
hand-written kernel ``csrc/threefry.cu`` (built with ``nvcc`` at first use
into ``build/``, loaded with ``ctypes``, launched on the current stream,
counted by ``utils.graphs.count_launch`` in ``threefry_draw.launches``).  On
the CPU the same numbers come from the plain torch version
(``threefry_plain``), which is also the kernel's reference.  Nothing falls
back: a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..utils import graphs

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: what each kernel launch writes (KIND in the source)
KINDS = {"folded": 0, "words": 1, "bits32": 2, "bits64": 3, "uniform": 4,
         "normal": 5}

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "threefry.cu"
_LIB_NAME = "libthreefry.so"


# ---- the hash ---------------------------------------------------------------
def threefry2x32(k1, k2, x1, x2):
    """threefry2x32 (20 rounds) of the counters ``(x1, x2)`` under the key
    ``(k1, k2)``; int64 tensors holding uint32 words, broadcast together.
    The rounds run on int32 words, whose additions wrap as uint32's do (a
    right shift is masked to be logical), in place."""
    k1, k2, x1, x2 = (_int32(t) for t in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    x1 = (x1 + ks[0]).expand(shape).clone()
    x2 = (x2 + ks[1]).expand(shape).clone()
    hi = torch.empty_like(x2)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2)
            torch.bitwise_left_shift(x2, r, out=hi)
            x2.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            x2.bitwise_or_(hi).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3])
        x2.add_(ks[(i + 2) % 3] + (i + 1))
    return x1.to(torch.int64) & MASK, x2.to(torch.int64) & MASK


def _int32(t):
    """uint32 words held in int64 as the int32 of the same bits."""
    return ((t + 2**31) % 2**32 - 2**31).to(torch.int32)


def _check_keys(keys):
    if not isinstance(keys, torch.Tensor) or keys.dtype != torch.int64 \
            or keys.dim() < 1 or keys.shape[-1] != 2:
        raise TypeError("keys are int64 tensors (..., 2) of uint32 words "
                        f"(got {getattr(keys, 'dtype', type(keys))} "
                        f"{tuple(getattr(keys, 'shape', ()))})")


def _out_shape(shape, index):
    shape = tuple(int(s) for s in shape)
    if index is None:
        return shape
    if not shape:
        raise ValueError("a draw at an index list needs a last dim to cut")
    return shape[:-1] + (int(index.numel()),)


def _float_consts(dtype):
    """(lo, hi) of a normal's uniform, in ``dtype``."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = np.nextafter(np.array(-1.0, np_dtype), np.array(0.0, np_dtype))
    return float(lo), 1.0


def threefry_plain(kind: str, keys, shape=(), dtype=None, fold=None,
                   index=None, minval=0.0, maxval=1.0):
    """The plain torch version of one kernel launch: ``kind`` (``KINDS``) at
    the per-key ``shape``, from ``keys`` (folded with ``fold`` first), at
    the counters ``index`` along the last dim if given.  "folded" is the
    folded keys themselves; "words" the two hash words ``(..., 2)``."""
    _check_keys(keys)
    K = tuple(keys.shape[:-1])
    k1, k2 = keys[..., 0], keys[..., 1]
    if fold is not None:       # made on the device: a captured body copies
        d = (fold.to(torch.int64) & MASK if isinstance(fold, torch.Tensor)
             else torch.full_like(k1, int(fold) & MASK))
        k1, k2 = threefry2x32(k1, k2, torch.zeros_like(d), d.expand(K))
    if kind == "folded":
        return torch.stack(torch.broadcast_tensors(k1, k2), -1)
    shape = tuple(int(s) for s in shape)
    out = _out_shape(shape, index)
    n = math.prod(shape[:-1]) if index is not None else math.prod(shape)
    if index is None:
        ctr = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(out)
    else:
        lead = torch.arange(n, dtype=torch.int64, device=keys.device)
        ctr = (lead.reshape(out[:-1] + (1,)) * shape[-1]
               + index.to(device=keys.device, dtype=torch.int64))
    bk = (1,) * len(out)
    b1, b2 = threefry2x32(k1.reshape(K + bk), k2.reshape(K + bk),
                          ctr >> 32, ctr & MASK)
    if kind == "words":
        return torch.stack([b1, b2], -1)
    if kind == "bits32":
        return b1 ^ b2
    if kind == "bits64":
        return (b1 << 32) | b2
    if kind == "normal":
        minval, maxval = _float_consts(dtype)
    if dtype == torch.float32:
        f = ((b1 ^ b2) >> 9 | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        f = ((b1 << 20) | (b2 >> 12) | 0x3FF0000000000000).view(torch.float64)
    else:
        raise TypeError(f"uniform and normal draws are float32 or float64 "
                        f"(got {dtype})")
    u = f - 1.0
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    if (minval, maxval) != (0.0, 1.0):
        # Python numbers holding the values of ``dtype`` exactly
        lo = np_dtype(minval)
        span = float(np_dtype(maxval) - lo)
        u = torch.clamp(u * span + float(lo), min=float(lo))
    if kind == "uniform":
        return u
    return torch.erfinv(u) * float(np_dtype(math.sqrt(2.0)))


# ---- the kernel --------------------------------------------------------------
def _lib_path() -> Path:
    from .fused_glmm import BUILD_DIR
    return BUILD_DIR / _LIB_NAME


def build_library() -> Path:
    """Compile ``csrc/threefry.cu`` for sm_90a unless the library is newer
    than its source; the compiler's report is kept beside it."""
    from .fused_glmm import NVCC_FLAGS, _nvcc
    lib = _lib_path()
    if lib.exists() and lib.stat().st_mtime >= _SRC.stat().st_mtime:
        return lib
    if graphs.capturing():
        raise RuntimeError("the threefry library is built at first use, which "
                           "must come before a CUDA graph capture")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_name("libthreefry.build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build_library()))
    lib.threefry_draw.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double,
         ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p])
    lib.threefry_draw.restype = ctypes.c_int
    return lib


def threefry_draw(kind: str, keys, shape=(), dtype=None, fold=None,
                  index=None, minval=0.0, maxval=1.0):
    """One draw: the plain version for keys on the CPU, one launch of the
    kernel for keys on a CUDA device (``threefry_draw.launches`` counts
    them).  The kernel reads the keys where they lie (a view of ``split``'s
    result, an expanded key), copying them only when their rows cannot be
    walked with one stride."""
    _check_keys(keys)
    if keys.device.type == "cpu":
        return threefry_plain(kind, keys, shape, dtype, fold, index, minval,
                              maxval)
    if keys.device.type != "cuda":
        raise ValueError(f"threefry draws run on the CPU or a CUDA device "
                         f"(got {keys.device})")
    dev = keys.device
    K = tuple(keys.shape[:-1])
    B = math.prod(K)
    rows = keys.reshape(B, 2)
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    shape = tuple(int(s) for s in shape)
    out = () if kind == "folded" else _out_shape(shape, index)
    n = math.prod(out)
    fold_ptr, fold_value, fold_stride = 0, 0, -1
    if fold is not None:
        if isinstance(fold, torch.Tensor):
            if fold.device != dev or fold.numel() not in (1, B):
                raise ValueError(f"fold must be a scalar or a tensor of one "
                                 f"value per key on {dev}")
            fold = fold.to(torch.int64).contiguous()
            fold_ptr, fold_stride = fold.data_ptr(), int(fold.numel() > 1)
        else:
            fold_value, fold_stride = int(fold) & MASK, 0
    idx_ptr, m, D = 0, 0, 0
    if index is not None:
        if index.device != dev:
            raise ValueError("index must lie on the keys' device")
        index = index.to(torch.int64).contiguous()
        idx_ptr, m, D = index.data_ptr(), index.numel(), shape[-1]
    if kind in ("uniform", "normal"):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"uniform and normal draws are float32 or float64 "
                            f"(got {dtype})")
        odt = dtype
        if kind == "normal":
            minval, maxval = _float_consts(dtype)
    else:
        odt = torch.int64
    full = K + out + ((2,) if kind in ("folded", "words") else ())
    res = torch.empty(full, dtype=odt, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.threefry_draw(
            rows.data_ptr(), rows.stride(0), B, fold_ptr, fold_value,
            fold_stride, n, idx_ptr, m, D, KINDS[kind],
            int(odt == torch.float64), float(minval), float(maxval),
            res.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: cudaError {err}")
    graphs.count_launch(threefry_draw)
    return res


threefry_draw.launches = 0


# ---- keys ---------------------------------------------------------------------
def key(seed: int, device="cpu"):
    """The key of an integer seed: ``(seed >> 32, seed & 0xffffffff)``, as
    ``jax.random.key`` makes it."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in(keys, data):
    """``keys`` folded with ``data`` (an int, or a tensor of one per key)."""
    return threefry_draw("folded", keys, fold=data)


def split(keys, n: int = 2):
    """``n`` new keys per key, ``(n, ..., 2)``; key ``i`` is
    ``fold_in(keys, i)``.  ``k, sub = split(keys)`` unpacks them (views of
    one draw of the hash words)."""
    return threefry_draw("words", keys, (n,)).movedim(-2, 0)


def chain_keys(seed: int, indices, device="cpu"):
    """``fold_in(key(seed), i)`` for each global chain index ``i``."""
    idx = torch.as_tensor(indices, dtype=torch.int64, device=device)
    base = key(seed, device).expand(idx.shape + (2,))
    return fold_in(base, idx)


# ---- draws --------------------------------------------------------------------
def bits(keys, shape=(), width: int = 32, fold=None, index=None):
    """Random bits (int64 holding uint32, or the uint64 bits as int64)."""
    if width not in (32, 64):
        raise ValueError("bits are 32 or 64 wide")
    return threefry_draw(f"bits{width}", keys, shape, fold=fold, index=index)


def uniform(keys, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0,
            fold=None, index=None):
    """Uniform numbers on [minval, maxval) (``jax.random.uniform``)."""
    return threefry_draw("uniform", keys, shape, dtype, fold, index,
                         minval, maxval)


def normal(keys, shape=(), dtype=torch.float32, fold=None, index=None):
    """Standard normals (``jax.random.normal``)."""
    return threefry_draw("normal", keys, shape, dtype, fold, index)


def exponential(keys, shape=(), dtype=torch.float32, fold=None):
    """Standard exponentials, ``-log1p(-u)`` (``jax.random.exponential``)."""
    return -torch.log1p(-uniform(keys, shape, dtype, fold=fold))


def gumbel(keys, shape=(), dtype=torch.float32, fold=None):
    """Standard Gumbel numbers (``jax.random.gumbel``, its "low" mode)."""
    tiny = float(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(uniform(keys, shape, dtype, tiny, 1.0,
                                         fold=fold)))


def categorical(keys, logits, fold=None):
    """One index per row of ``logits`` (``keys.shape[:-1]`` leading, then
    any batch, then the categories): ``argmax(gumbel + logits)``."""
    nk = keys.dim() - 1
    g = gumbel(keys, tuple(logits.shape[nk:]), logits.dtype, fold=fold)
    return torch.argmax(g + logits, dim=-1)


def _per_key(keys, t):
    """``t`` with a dim of 1 put after the keys' batch dims, so that it
    broadcasts against a per-key draw whose shape starts with a round
    axis."""
    nk = keys.dim() - 1
    return t.reshape(tuple(t.shape[:nk]) + (1,) + tuple(t.shape[nk:]))


def _param(keys, a, dtype=None):
    """``a`` as a tensor on the keys' device, led by the keys' batch dims:
    a value not led by them is shared by every key."""
    K = tuple(keys.shape[:-1])
    if not isinstance(a, torch.Tensor):     # filled on the device: no copy
        return torch.full(K, float(a), dtype=dtype or torch.get_default_dtype(),
                          device=keys.device)
    if dtype is None:
        dtype = a.dtype if a.is_floating_point() else torch.get_default_dtype()
    a = a.to(device=keys.device, dtype=dtype)
    if tuple(a.shape[:len(K)]) != K:
        a = a.expand(K + tuple(a.shape))
    return a


def gamma_bounded(keys, a, shape=(), dtype=None, rounds: int = 8):
    """Gamma(a, 1) draws with a fixed ``rounds``-proposal Marsaglia-Tsang
    sampler (the JAX package's ``ops/rng.py``): per key ``shape +
    a.shape[len(batch):]``, ``a`` led by the keys' batch dims (or a scalar).
    A miss in every round (below 1e-10 for a >= 1) gives the mode; a < 1
    takes the boost ``Gamma(a + 1) U^(1/a)``."""
    a = _param(keys, a, dtype)
    dtype = a.dtype
    nk = keys.dim() - 1
    K, s = tuple(a.shape[:nk]), tuple(a.shape[nk:])
    shape = tuple(shape)
    out = shape + s
    kb, kn, ku = split(keys, 3)
    ab_ = a.reshape(K + (1,) * len(shape) + s)
    small = ab_ < 1.0
    ab = torch.where(small, ab_ + 1.0, ab_)
    d = ab - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    x = normal(kn, (rounds,) + out, dtype)
    u = uniform(ku, (rounds,) + out, dtype)
    dr, cr = _per_key(keys, d), _per_key(keys, c)
    t = 1.0 + cr * x
    v = t * (t * t)
    pos = v > 0.0
    accept = pos & (torch.log(u) < 0.5 * x * x + dr - dr * v
                    + dr * torch.log(torch.where(pos, v, torch.ones_like(v))))
    idx = torch.argmax(accept.to(torch.int8), dim=nk)
    any_acc = accept.any(dim=nk)
    vsel = torch.take_along_dim(v, idx.unsqueeze(nk), dim=nk).squeeze(nk)
    g = d * torch.where(any_acc, vsel, torch.ones_like(vsel))
    tiny = float(torch.finfo(dtype).tiny)
    boost = torch.exp(torch.log(uniform(kb, out, dtype, tiny, 1.0)) / ab_)
    return torch.where(small, g * boost, g)


def inverse_gamma_bounded(keys, a, b, shape=(), dtype=None, rounds: int = 8):
    """InverseGamma(a, b) through ``gamma_bounded``: ``b / Gamma(a)``, in
    ``b``'s dtype where ``a`` is a Python number.  A number ``b`` is filled
    on the device (no copy from the host: a captured body may draw)."""
    if dtype is None and not isinstance(a, torch.Tensor) \
            and isinstance(b, torch.Tensor) and b.is_floating_point():
        dtype = b.dtype
    g = gamma_bounded(keys, a, shape=shape, dtype=dtype, rounds=rounds)
    if isinstance(b, (int, float)):
        return torch.full_like(g, b) / g
    return torch.as_tensor(b, dtype=g.dtype, device=g.device) / g


#: terms of the inversion below a mean of 10: P(Poisson(10) > 40) < 2e-13
INVERSION_TERMS = 41
#: rounds of transformed rejection: each accepts with probability > 0.85
REJECTION_ROUNDS = 16
_SMALL_MEAN = 10.0


def _inversion(u, log_p0, ratio):
    """``#{k < INVERSION_TERMS : cdf(k) < u}`` for the pmf with
    ``pmf(0) = exp(log_p0)`` and ``pmf(k) / pmf(k - 1) = ratio(k)``."""
    k = torch.arange(1, INVERSION_TERMS, dtype=u.dtype, device=u.device)
    steps = torch.clamp(ratio(k), min=0.0)
    pmf = torch.exp(log_p0)[..., None] * torch.cat(
        [torch.ones_like(steps[..., :1]), torch.cumprod(steps, -1)], -1)
    cdf = torch.cumsum(pmf, -1)
    return (cdf < u[..., None]).sum(-1).to(u.dtype)


def _first(accept, values, fallback, dim):
    """The value of the first accepted round along ``dim``, else
    ``fallback``."""
    idx = torch.argmax(accept.to(torch.int8), dim=dim)
    pick = torch.take_along_dim(values, idx.unsqueeze(dim), dim=dim).squeeze(dim)
    return torch.where(accept.any(dim=dim), pick, fallback)


def poisson(keys, lam, rounds: int = REJECTION_ROUNDS):
    """Poisson(lam) draws, ``lam`` led by the keys' batch dims: inversion
    below a mean of 10, PTRS (Hormann 1993) with ``rounds`` rounds above.
    Computed in float64; returned in ``lam``'s dtype."""
    lam = _param(keys, lam)
    dtype = lam.dtype
    nk = keys.dim() - 1
    s = tuple(lam.shape[nk:])
    L = lam.to(torch.float64)
    small = L < _SMALL_MEAN
    Ls = torch.where(small, L, torch.ones_like(L))
    u0 = uniform(keys, s, torch.float64, fold=0)
    x_small = _inversion(u0, -Ls, lambda k: Ls[..., None] / k)
    Lb = _per_key(keys, torch.where(small, torch.full_like(L, 2 * _SMALL_MEAN),
                                    L))
    uv = uniform(keys, (rounds, 2) + s, torch.float64, fold=1)
    U, V = uv.select(nk + 1, 0) - 0.5, uv.select(nk + 1, 1)
    slam, loglam = torch.sqrt(Lb), torch.log(Lb)
    b = 0.931 + 2.53 * slam
    a = -0.059 + 0.02483 * b
    invalpha = 1.1239 + 1.1328 / (b - 3.4)
    vr = 0.9277 - 3.6224 / (b - 2.0)
    us = torch.clamp(0.5 - torch.abs(U), min=1e-300)
    k = torch.floor((2.0 * a / us + b) * U + Lb + 0.43)
    quick = (us >= 0.07) & (V <= vr)
    reject = (us < 0.013) & (V > us)
    kk = torch.clamp(k, min=0.0)
    full = (torch.log(V) + torch.log(invalpha) - torch.log(a / (us * us) + b)
            <= -Lb + kk * loglam - torch.lgamma(kk + 1.0))
    accept = (k >= 0) & (quick | (~reject & full))
    x_large = _first(accept, kk, torch.floor(L), nk)
    return torch.where(small, x_small, x_large).to(dtype)


def binomial(keys, n, p, rounds: int = REJECTION_ROUNDS):
    """Binomial(n, p) draws, ``n`` and ``p`` led by the keys' batch dims:
    with ``q = min(p, 1 - p)``, inversion where ``n q < 10`` and BTRS
    (Hormann 1993) with ``rounds`` rounds elsewhere; a draw at ``1 - p`` is
    reflected.  Computed in float64; returned in ``p``'s dtype."""
    p = _param(keys, p)
    dtype = p.dtype
    n, p = torch.broadcast_tensors(_param(keys, n, torch.float64),
                                   p.to(torch.float64))
    nk = keys.dim() - 1
    s = tuple(p.shape[nk:])
    flip = p > 0.5
    q = torch.where(flip, 1.0 - p, p)
    small = n * q < _SMALL_MEAN
    qs = torch.where(small, q, torch.zeros_like(q))
    ns = torch.where(small, n, torch.zeros_like(n))
    u0 = uniform(keys, s, torch.float64, fold=0)
    r = qs / (1.0 - qs)
    x_small = torch.minimum(_inversion(
        u0, ns * torch.log1p(-qs),
        lambda k: (ns[..., None] - k + 1.0) / k * r[..., None]), ns)
    nb = _per_key(keys, torch.where(small, torch.full_like(n, 100.0), n))
    pb = _per_key(keys, torch.where(small, torch.full_like(q, 0.5), q))
    uv = uniform(keys, (rounds, 2) + s, torch.float64, fold=1)
    U, V = uv.select(nk + 1, 0) - 0.5, uv.select(nk + 1, 1)
    qb = 1.0 - pb
    spq = torch.sqrt(nb * pb * qb)
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * pb
    c = nb * pb + 0.5
    vr = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spq
    lpq = torch.log(pb / qb)
    m = torch.floor((nb + 1.0) * pb)
    h = torch.lgamma(m + 1.0) + torch.lgamma(nb - m + 1.0)
    us = torch.clamp(0.5 - torch.abs(U), min=1e-300)
    k = torch.floor((2.0 * a / us + b) * U + c)
    valid = (k >= 0) & (k <= nb)
    kk = torch.clamp(k, min=0.0)
    kk = torch.minimum(kk, nb)
    quick = (us >= 0.07) & (V <= vr)
    full = (torch.log(V * alpha / (a / (us * us) + b))
            <= h - torch.lgamma(kk + 1.0) - torch.lgamma(nb - kk + 1.0)
            + (kk - m) * lpq)
    accept = valid & (quick | full)
    x_large = _first(accept, kk, torch.floor((n + 1.0) * q), nk)
    x = torch.where(small, x_small, x_large)
    return torch.where(flip, n - x, x).to(dtype)
