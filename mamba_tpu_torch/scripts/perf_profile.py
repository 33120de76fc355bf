"""Achieved FLOP/s and bytes/s of the functions the engine runs hot.

Counterpart of the JAX package's ``scripts/perf_profile.py``.  For the
rats model (NUTS scheme) and the fused GLMM at full width (G = 10,000),
both at 1024 chains, it times on the card, through
``utils.roofline.roofline``:

- ``grad``: ``vmap(grad_and_value(logf))`` of the NUTS block over all
  chains, the inner loop of every leapfrog;
- ``logf``: the block density alone (what Slice and MH kernels call);
- ``gibbs``: one Gibbs iteration of every block (adaptation off), replayed
  from one generator state so that every timed call does the same work.

PyTorch has no cost analysis, so the work is counted while one call runs:
a dispatch mode adds, for every aten op, one operation per output element
of a pointwise op, one per input element of a reduction and 2mnk for a
matrix product (views and copies count none); each launch of the fused
GLMM kernel adds ``ops.fused_glmm.glmm_work``'s count.  Bytes are the
call's inputs read once and outputs written once.  It prints the numbers,
with the card's name and power limit, and writes nothing.

    python3 -m mamba_tpu_torch.scripts.perf_profile [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils.roofline import _tensors

#: both models at the chain count of the GLMM's bench arm, the GLMM at its
#: bench width
CHAINS = 1024
GLMM_GROUPS = 10_000

_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "addbmm", "dot", "mv"}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


class OpCount(TorchDispatchMode):
    """Operations of the aten ops that run while the mode is on."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _MATMULS:
            k = args[-2].shape[-1]           # the contracted dim of a @ b
            self.flops += 2 * k * _numel(out)
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(_numel(t) for t in _tensors(out))
        elif torch.Tag.reduction in getattr(func, "tags", ()) or name in (
                "sum", "mean", "amax", "amin", "prod", "logsumexp", "norm"):
            self.flops += _numel(args[0])
        return out


def count_work(fn, *args, kernel_work=None):
    """(flops, bytes) of one call ``fn(*args)``: the aten ops' count, plus
    ``kernel_work(launches)`` for the fused kernel's launches, and the
    bytes of every distinct input and output tensor."""
    from ..ops import fused_glmm as fg
    before = fg.glmm_loglik_grads.launches
    with OpCount() as oc:
        out = fn(*args)
    flops = oc.flops
    if kernel_work is not None:
        flops += kernel_work(fg.glmm_loglik_grads.launches - before)
    seen, nbytes = set(), 0
    for t in list(_tensors(args)) + list(_tensors(out)):
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            nbytes += t.numel() * t.element_size()
    return flops, nbytes


def profile_model(model, inputs, inits, chains, device, kernel_work=None,
                  gibbs_iters=3):
    """grad, logf and gibbs of ``model``'s first (gradient) block."""
    from ..model.compile import compile_model
    from ..model.mcmc import _chain_inits
    from ..utils.roofline import roofline
    cm = compile_model(model, inputs, inits, device=device)
    kernels = [s.build(cm) for s in model.samplers]
    state = _chain_inits(cm, inits, chains)
    gen = torch.Generator(device=cm.device)
    gen.manual_seed(0)
    tunes = tuple(k.init(gen, state) for k in kernels)
    params = tuple(model.samplers[0].params)
    pack, _, _, logf = cm.block_functions(params, True)
    x = torch.func.vmap(pack)(state)
    grad = torch.func.vmap(torch.func.grad_and_value(logf))
    vlogf = torch.func.vmap(logf)
    g0 = gen.get_state()

    def gibbs(state, tunes):
        gen.set_state(g0)             # the same draws, the same work
        for k, tune in zip(kernels, tunes):
            state, _ = k.step(gen, state, tune, False)
        return state

    out = {"chains": chains, "block_dim": int(x.shape[-1])}
    for name, fn, args, iters in (("grad", grad, (x, state), 20),
                                  ("logf", vlogf, (x, state), 20),
                                  ("gibbs", gibbs, (state, tunes), gibbs_iters)):
        flops, nbytes = count_work(fn, *args, kernel_work=kernel_work)
        out[name] = roofline(fn, *args, flops=flops, bytes=nbytes,
                             iters=iters, warmup=1)
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..models import glmm, rats
    from ..ops import fused_glmm as fg
    res = {"device": args.device}
    if args.device.startswith("cuda"):
        res["card"] = card()
        res["kind"] = torch.cuda.get_device_name(0)
    model, inputs, inits = rats.build("nuts")
    res["rats_nuts"] = profile_model(model, inputs, inits[0], CHAINS,
                                     args.device)
    model, inputs, inits, _ = glmm.build(GLMM_GROUPS, fused=True)

    def kernel_work(launches):
        return launches * fg.glmm_work(glmm.P, 10, GLMM_GROUPS,
                                       CHAINS)["flops"]

    res["glmm_fused_nuts"] = profile_model(model, inputs, inits[0], CHAINS,
                                           args.device, kernel_work=kernel_work)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
