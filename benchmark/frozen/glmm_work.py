"""What one call of the GLMM likelihood and its gradients must do, and the
least time an H100 could take for it.

Frozen copy of ``mamba_tpu_torch/ops/fused_glmm.py``'s ``glmm_work`` and
``glmm_bound_ms`` and of the H100 SXM peaks in
``mamba_tpu_torch/utils/roofline.py``, at commit
fc13fd826c36831480dadd26fb8e0f34af6cabfa.  The count is of the function
(``lp``, ``grad_beta`` and ``grad_b`` for C chains over G groups of n
observations with P fixed effects), not of a kernel's design.
"""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    """Published peaks of one card: float32 FLOP/s outside the tensor cores,
    dense bf16 tensor-core FLOP/s, device-memory bytes/s, streaming
    multiprocessors, and special-function results per clock per SM."""
    fp32_flops: float
    bf16_flops: float
    bytes_per_s: float
    sms: int
    sfu_per_clock_per_sm: int


#: NVIDIA's data sheet, H100 SXM ("NVIDIA H100 80GB HBM3"), dense rates
H100_SXM = Peaks(fp32_flops=67e12, bf16_flops=989e12, bytes_per_s=3.35e12,
                 sms=132, sfu_per_clock_per_sm=16)

#: the H100 SXM's boost SM clock, at which the special-function floor is set
H100_SM_CLOCK_HZ = 1980e6


def glmm_work(P: int, n: int, G: int, C: int) -> dict:
    """``bytes``: every input read once, every output written once, float32.
    ``flops``: 2P float32 operations for the logit, 2P for grad_beta and 12
    for the rest of an observation; ``sfu``: three special-function results
    an observation.  ``poly_log_*``: the form with a polynomial logarithm
    (two special-function results, 14 more float32 operations)."""
    N = C * n * G
    floats = P * n * G + n * G + C * P + C * G + C + C * P + C * G
    return {"bytes": 4 * floats, "flops": (4 * P + 12) * N, "sfu": 3 * N,
            "poly_log_flops": (4 * P + 26) * N, "poly_log_sfu": 2 * N}


def glmm_bound_ms(P: int, n: int, G: int, C: int,
                  sm_clock_hz: float = H100_SM_CLOCK_HZ,
                  peaks: Peaks = H100_SXM) -> dict:
    """The least time in ms for one call: each form of the arithmetic needs
    the larger of its float32 and special-function floors, the card may
    take the cheaper form, and memory holds for both (``bound_ms``, with the
    floor that sets it as ``bound_by``)."""
    work = glmm_work(P, n, G, C)
    sfu_rate = peaks.sms * peaks.sfu_per_clock_per_sm * sm_clock_hz
    out = {"memory_ms": 1e3 * work["bytes"] / peaks.bytes_per_s,
           "fp32_ms": 1e3 * work["flops"] / peaks.fp32_flops,
           "sfu_ms": 1e3 * work["sfu"] / sfu_rate,
           "poly_log_fp32_ms": 1e3 * work["poly_log_flops"] / peaks.fp32_flops,
           "poly_log_sfu_ms": 1e3 * work["poly_log_sfu"] / sfu_rate}
    forms = [max((out[f"{form}fp32_ms"], "fp32"), (out[f"{form}sfu_ms"], "sfu"))
             for form in ("", "poly_log_")]
    ms, by = max(min(forms), (out["memory_ms"], "memory"))
    return {**out, "bound_ms": ms, "bound_by": by}
