"""The model step's share of the float32 peak (67 TFLOP/s): the model's work
per gradient evaluation (the reference's ``gradient_flops``) times the
gradient evaluations that the algorithm makes in the unprofiled restart
(ChEES's leapfrog steps of each trajectory, from its tune: frozen
``chees_steps``), over the restart's wall seconds.  The count is of the
algorithm, so a change that captures, caches or fuses gradients moves the
time and not the work."""

from benchmark.frozen.chees_steps import window_steps
from benchmark.frozen.glmm_work import H100_SXM


def read(run):
    flops = getattr(run.reference, "gradient_flops", None)
    tunes = run.plain.get("tunes") or ()
    grads = window_steps(tunes[0], run.plain["iters"]) if tunes else None
    if flops is None or grads is None:
        return None
    work = flops(run.config, run.chains) * grads
    return 100.0 * work / (run.plain["seconds"] * H100_SXM.fp32_flops)
