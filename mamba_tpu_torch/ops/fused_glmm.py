"""Fused Bernoulli-logit GLMM log-likelihood and gradients.

The hot function of the GLMM model (models/glmm.py with ``fused=True``) is
``value_and_grad`` of

    lp(beta, b) = sum_{i,g} [ y * l - softplus(l) ],
    l[i, g] = sum_p Xt[p, i, g] * beta[p] + b[g]

evaluated for every chain at every NUTS leapfrog.  On a CUDA device one
hand-written kernel (``csrc/fused_glmm.cu``) computes the log-likelihood and
both gradients for all chains in one pass, without writing the logits to
device memory.  On the CPU the same function runs as plain torch ops
(``glmm_loglik_grads_plain``), which is also the kernel's reference.

The kernel's library is built with ``nvcc`` at first use into ``build/`` at
the root of the checkout and loaded with ``ctypes``.

``bernoulli_logit_glmm_loglik`` wraps the call in a ``torch.autograd.Function``
whose forward already holds the gradients, so ``grad_and_value`` costs one
kernel launch, and whose ``vmap`` rule turns ``torch.func.vmap`` over chains
into one chain-batched launch.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import bijectors as bij
from .distributions.base import Distribution, distribution

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fused_glmm.cu"
#: build directory at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_LIB_PATH = BUILD_DIR / "libfused_glmm.so"
_LOG_PATH = BUILD_DIR / "fused_glmm.build.log"
#: fixed effects the kernel holds in registers (MAX_P in the source)
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
    memory report included) is kept in ``build/fused_glmm.build.log``."""
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    _LOG_PATH.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
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
    return lib


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
    ``glmm_loglik_grads.launches`` counts the kernel launches."""
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
    lp = torch.empty(C, dtype=torch.float32, device=dev)
    gbeta = torch.empty(C, P, dtype=torch.float32, device=dev)
    gb = torch.empty(C, G, dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.fused_glmm_scratch_floats(P, G, C),
                          dtype=torch.float32, device=dev)
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
        lp, gbeta, gb = glmm_loglik_grads(Xt, y, beta[None].contiguous(),
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

    def sample(self, gen, shape=()):
        p = torch.sigmoid(self._logits())
        u = torch.rand(tuple(shape) + tuple(p.shape), generator=gen,
                       dtype=p.dtype, device=p.device)
        return (u < p).to(p.dtype)

    def bijector(self):
        return bij.Discrete()

    def mean(self):
        return torch.sigmoid(self._logits())
