"""Fused Bernoulli-logit GLMM log-likelihood and gradients.

The hot function of the GLMM model (models/glmm.py with ``fused=True``) is
``value_and_grad`` of

    lp(beta, b) = sum_{i,g} [ y * l - softplus(l) ],
    l[i, g] = sum_p Xt[p, i, g] * beta[p] + b[g]

evaluated for every chain at every leapfrog.  On a CUDA device one
hand-written kernel (``csrc/fused_glmm.cu``) computes the log-likelihood and
both gradients for all chains in one pass, without writing the logits to
device memory.  On the CPU the same function runs as plain
torch ops (``glmm_loglik_grads_plain``), which is also the kernel's reference.
``glmm_work`` and ``glmm_bound_ms`` count a call's work and the least time an
H100 could take for it.

The kernel's library is built with ``nvcc`` at first use into ``build/`` at
the root of the checkout and loaded with ``ctypes``.

``bernoulli_logit_glmm_loglik`` wraps the call in a ``torch.autograd.Function``
whose forward already holds the gradients, so ``grad_and_value`` costs one
kernel launch, and whose ``vmap`` rule turns ``torch.func.vmap`` over chains
into one chain-batched launch.

Under a mesh's data axis each data rank launches the kernel on its own
contiguous range of groups (``BernoulliLogitGLMM.log_prob_range``): the
covariates' slice is cut once where the compiled model plans the split,
``y``'s and ``b``'s are made contiguous per call, and the engine sums ``lp`` and ``grad_beta`` over the
data group while autograd places ``grad_b`` at the range's groups.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.roofline import H100_SXM
from . import bijectors as bij
from .distributions.base import Distribution, distribution

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_glmm.cu"
#: build directory at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_LIB_PATH = BUILD_DIR / "libfused_glmm.so"
#: what nvcc and ptxas said when the library was last built
BUILD_LOG = BUILD_DIR / "libfused_glmm.build.log"
#: how the source is compiled: Hopper only, ptxas' resource report kept
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
#: fixed effects the kernel takes (MAX_P in the source)
MAX_P = 8



def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the fused GLMM kernel is built "
                           "with the CUDA toolkit's compiler")
    return nvcc


def build_library() -> Path:
    """Compile ``csrc/fused_glmm.cu`` for sm_90a unless the library is newer
    than its source.  The compiler's output (ptxas register and shared
    memory report included) is kept beside the library as ``BUILD_LOG``."""
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB_PATH
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, _LIB_PATH)      # atomic: a concurrent loader sees old or new
    return _LIB_PATH


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build_library()))
    lib.fused_glmm_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.fused_glmm_scratch_floats.restype = ctypes.c_longlong
    lib.fused_glmm_loglik_grads.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.fused_glmm_loglik_grads.restype = ctypes.c_int
    lib.fused_glmm_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fused_glmm_plan.restype = ctypes.c_int
    return lib


def glmm_work(P: int, n: int, G: int, C: int) -> dict:
    """What one call must do, from its shapes.  ``bytes``: every input read
    once, every output written once, float32.  ``flops`` and ``sfu`` count
    the arithmetic as the kernel does it: 2P float32 operations for the
    logit, 2P for grad_beta and 12 for the rest of an observation (each
    transcendental counted once), and three special-function (MUFU) results,
    an exp2, a log2 and a reciprocal.  Three is this design's count and no
    floor of the function: log(t) on t in (1, 2] can be a polynomial of about
    seven FMAs instead, which leaves two special-function results and adds 14
    float32 operations (``poly_log_sfu``, ``poly_log_flops``)."""
    N = C * n * G
    floats = P * n * G + n * G + C * P + C * G + C + C * P + C * G
    return {"bytes": 4 * floats, "flops": (4 * P + 12) * N, "sfu": 3 * N,
            "poly_log_flops": (4 * P + 26) * N, "poly_log_sfu": 2 * N}


def glmm_bound_ms(P: int, n: int, G: int, C: int, sm_clock_hz: float) -> dict:
    """The least time in ms an H100 could take for one call.  ``memory_ms``,
    ``fp32_ms`` and ``sfu_ms`` are the floors set by device memory, by float32
    arithmetic and by the special-function pipe at ``sm_clock_hz`` for the
    arithmetic as the kernel does it; ``poly_log_fp32_ms`` and
    ``poly_log_sfu_ms`` are those of the form with a polynomial logarithm
    (``glmm_work``).  Each form needs the larger of its two floors, the card
    may take the cheaper form, and memory holds for both: that is
    ``bound_ms``, with the floor that sets it (``"memory"``, ``"fp32"`` or
    ``"sfu"``) as ``bound_by``."""
    work = glmm_work(P, n, G, C)
    h100 = H100_SXM                  # peaks from utils/roofline.py
    sfu_rate = h100.sms * h100.sfu_per_clock_per_sm * sm_clock_hz
    out = {"memory_ms": 1e3 * work["bytes"] / h100.bytes_per_s,
           "fp32_ms": 1e3 * work["flops"] / h100.fp32_flops,
           "sfu_ms": 1e3 * work["sfu"] / sfu_rate,
           "poly_log_fp32_ms": 1e3 * work["poly_log_flops"] / h100.fp32_flops,
           "poly_log_sfu_ms": 1e3 * work["poly_log_sfu"] / sfu_rate}
    forms = [max((out[f"{form}fp32_ms"], "fp32"), (out[f"{form}sfu_ms"], "sfu"))
             for form in ("", "poly_log_")]
    ms, by = max(min(forms), (out["memory_ms"], "memory"))
    return {**out, "bound_ms": ms, "bound_by": by}


def glmm_loglik_grads_plain(Xt, y, betas, bs):
    """Plain torch version: ``(lp (C,), grad_beta (C, P), grad_b (C, G))``
    for ``Xt (P, n, G)``, ``y (n, G)``, ``betas (C, P)``, ``bs (C, G)``.
    The same arithmetic as the kernel (one shared ``exp(-|l|)``)."""
    l = torch.einsum("pig,cp->cig", Xt, betas) + bs[:, None, :]
    e = torch.exp(-torch.abs(l))
    softplus = torch.clamp(l, min=0.0) + torch.log1p(e)
    q = 1.0 / (1.0 + e)
    sig = torch.where(l >= 0, q, 1.0 - q)
    lp = torch.sum(y * l - softplus, dim=(1, 2))
    r = y - sig
    return lp, torch.einsum("cig,pig->cp", r, Xt), torch.sum(r, dim=1)


def glmm_loglik_grads(Xt, y, betas, bs):
    """``(lp, grad_beta, grad_b)`` for a batch of chains.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (float32, C-contiguous, one device), and anything else raises;
    ``glmm_loglik_grads.launches`` counts the kernel launches.  The three
    results are views of one allocation, which also holds the kernel's
    scratch."""
    args = (Xt, y, betas, bs)
    if all(t.device.type == "cpu" for t in args):
        return glmm_loglik_grads_plain(*args)
    dev = Xt.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError("fused GLMM: all tensors must be on one CUDA device "
                         f"(got {[str(t.device) for t in args]})")
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("fused GLMM kernel takes float32 tensors "
                        f"(got {[str(t.dtype) for t in args]})")
    if Xt.dim() != 3 or betas.dim() != 2:
        raise ValueError("fused GLMM: Xt must be (P, n, G) and betas (C, P)")
    P, n, G = Xt.shape
    C = betas.shape[0]
    if (tuple(y.shape) != (n, G) or tuple(betas.shape) != (C, P)
            or tuple(bs.shape) != (C, G)):
        raise ValueError(
            f"fused GLMM: shapes Xt {tuple(Xt.shape)}, y {tuple(y.shape)}, "
            f"betas {tuple(betas.shape)}, bs {tuple(bs.shape)} do not agree")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("fused GLMM kernel takes contiguous tensors")
    if not 1 <= P <= MAX_P or C < 1:
        raise ValueError(f"fused GLMM kernel takes 1..{MAX_P} fixed effects "
                         f"and at least one chain (got P={P}, C={C})")
    lib = _lib()
    sizes = [C, C * P, C * G, lib.fused_glmm_scratch_floats(P, G, C)]
    lp, gbeta, gb, scratch = torch.empty(
        sum(sizes), dtype=torch.float32, device=dev).split(sizes)
    gbeta, gb = gbeta.view(C, P), gb.view(C, G)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_glmm_loglik_grads(
            Xt.data_ptr(), y.data_ptr(), betas.data_ptr(), bs.data_ptr(),
            lp.data_ptr(), gbeta.data_ptr(), gb.data_ptr(), scratch.data_ptr(),
            P, n, G, C, stream)
    if err != 0:
        raise RuntimeError(f"fused GLMM kernel launch failed: cudaError {err}")
    glmm_loglik_grads.launches += 1
    return lp, gbeta, gb


glmm_loglik_grads.launches = 0


def kernel_plan(P: int, n: int, G: int, C: int) -> dict:
    """How the library would run a call of this shape on the current CUDA
    device: which of its two kernels, chains per block, blocks in the grid
    and the blocks the device holds at once."""
    out = (ctypes.c_int * 4)()
    err = _lib().fused_glmm_plan(P, n, G, C, out)
    if err != 0:
        raise RuntimeError(f"fused GLMM kernel takes no such shape: "
                           f"cudaError {err}")
    return {"kernel": "glmm_reg_kernel" if out[0] else "glmm_generic_kernel",
            "chains_per_block": out[1], "blocks": out[2],
            "resident_blocks": out[3]}


class bernoulli_logit_glmm_loglik(torch.autograd.Function):  # noqa: N801
    """``apply(Xt, y, beta, b) -> (lp, grad_beta, grad_b)``:
    sum_{i,g} log Bernoulli(y[i,g] | sigmoid(Xt[:,i,g]·beta + b[g])) and its
    gradients, for Xt (P, n, G), y (n, G) in {0,1}, beta (P,), b (G,).

    **Contract: Xt and y must be constants (data).**  ``backward`` returns
    no gradient for them, so if Xt or y were computed from sampled
    parameters (e.g. through a logical node) their gradient would silently
    vanish.  Likewise ``vmap`` over chains shares ONE y across the batch
    (the engine chain-stacks observed data with identical rows); per-chain
    differing observations — MISS imputation over this node — are rejected
    by the engine (``supports_imputation=False``)."""

    generate_vmap_rule = False

    @staticmethod
    def forward(Xt, y, beta, b):
        lp, gbeta, gb = glmm_loglik_grads(Xt.contiguous(), y.contiguous(),
                                          beta[None].contiguous(),
                                          b[None].contiguous())
        return lp[0], gbeta[0], gb[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, gbeta, gb = output
        ctx.mark_non_differentiable(gbeta, gb)
        ctx.save_for_backward(gbeta, gb)

    @staticmethod
    def backward(ctx, ct, _ct_gbeta, _ct_gb):
        gbeta, gb = ctx.saved_tensors
        return None, None, ct * gbeta, ct * gb

    @staticmethod
    def vmap(info, in_dims, Xt, y, beta, b):
        """vmap over chains is one chain-batched call."""
        xt_d, y_d, beta_d, b_d = in_dims
        if xt_d is not None:
            raise NotImplementedError(
                "fused GLMM kernel: covariates cannot be vmapped")
        if y_d is not None:
            # the engine chain-stacks every stochastic site, observed data
            # included, so y arrives batched with identical rows
            y = y.select(y_d, 0)
        C = info.batch_size
        beta = (beta.movedim(beta_d, 0) if beta_d is not None
                else beta.expand(C, *beta.shape))
        b = b.movedim(b_d, 0) if b_d is not None else b.expand(C, *b.shape)
        out = glmm_loglik_grads(Xt.contiguous(), y.contiguous(),
                                beta.contiguous(), b.contiguous())
        return out, (0, 0, 0)


@distribution
class BernoulliLogitGLMM(Distribution):
    """Whole-array Bernoulli-logit GLMM likelihood as one distribution:
    the (n, G) observation matrix is a single event whose log_prob is the
    fused kernel.  Drop-in for a stochastic data node — the graph
    compiler's generic ``_site_lp`` path needs nothing special."""

    Xt: torch.Tensor     # (P, n, G)
    beta: torch.Tensor   # (P,)
    b: torch.Tensor      # (G,)

    event_ndim = 2
    #: the event splits along its groups (dim 1 of y): a part of the
    #: likelihood is the kernel over a range of groups (``log_prob_range``)
    event_split_dim = 1
    is_discrete = True
    #: the fused kernel shares one y across the chain batch — MISS
    #: imputation (per-chain y values) would silently evaluate every chain
    #: against chain 0's data, so the engine rejects NaN inits on this node
    #: (model/mcmc.py _chain_inits).  Use fused=False for missing data.
    supports_imputation = False

    @property
    def batch_shape(self):
        return torch.Size()

    @property
    def event_shape(self):
        return self.Xt.shape[1:]

    def _logits(self):
        return torch.einsum("pig,p->ig", self.Xt, self.beta) + self.b[None, :]

    def log_prob(self, x):
        return bernoulli_logit_glmm_loglik.apply(self.Xt, x, self.beta,
                                                 self.b)[0]

    def total_log_prob(self, x):
        # honor support like the generic Bernoulli does: non-binary y yields
        # -inf, not a silently-wrong density
        return torch.where(self.in_support(x), self.log_prob(x), -torch.inf)

    def in_support(self, x):
        return torch.all((x == 0.0) | (x == 1.0))

    def split_constants(self, lo: int, hi: int):
        """The covariates of groups ``lo..hi-1``, contiguous.  The compiled
        model cuts them once, from its example distribution, where it plans
        the split: the covariates are data, the same on every call."""
        return self.Xt[:, :, lo:hi].contiguous()

    def log_prob_range(self, x, lo: int, hi: int, Xt):
        """The log-likelihood of groups ``lo..hi-1`` alone, -inf if their
        ``y`` leave {0, 1}: one launch over the range, on ``Xt``, the
        covariates' slice from ``split_constants(lo, hi)``."""
        y = x[:, lo:hi]
        lp = bernoulli_logit_glmm_loglik.apply(Xt, y, self.beta,
                                               self.b[lo:hi])[0]
        return torch.where(self.in_support(y), lp, -torch.inf)

    def sample(self, gen, shape=()):
        p = torch.sigmoid(self._logits())
        u = torch.rand(tuple(shape) + tuple(p.shape), generator=gen,
                       dtype=p.dtype, device=p.device)
        return (u < p).to(p.dtype)

    def bijector(self):
        return bij.Discrete()

    def mean(self):
        return torch.sigmoid(self._logits())
