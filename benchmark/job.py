"""One run of one cell: set-up, the measured window, the output check.

A modeller's job: a model, many chains in lockstep, a warm start where the
traffic asks for one, a warm-up, then kept draws.  Set-up is everything
before the window: the imports, the kernels' build or load from
``build/``, the data, the model, the warm start, the warm-up
(``mcmc(model, inputs, inits, burnin + 1, burnin=burnin)``) and one short
restart whose rate sizes the window.  The window is one restart through
the public API, ``mcmc(sim, K)``, timed by the host's clock around the
call, which ends with the draws on the host; like a user's restart it
builds its samplers anew and captures their graphs (``capture_s``).  The
traced run splits the window into a restart without the profiler and a
profiled restart of a few iterations (``trace.py``).

Only the port's public ``mcmc``, ``advi``, sampler classes and model
``build`` functions are driven; none of its functions is patched.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import check
from benchmark.frozen import ess as fe

#: the fewest kept iterations of a window: split chains of 20 draws, enough
#: for the ESS's autocorrelations however fast the program gets
MIN_WINDOW_ITERS = 40


class Run:
    """What the metrics' readers read from one run."""

    def __init__(self, **kw):
        self.slice = None
        self.__dict__.update(kw)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)


@contextlib.contextmanager
def _clock(spans: dict, name: str, device):
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    spans[name] = time.perf_counter() - t0


def set_samplers(mt, model, specs: list[dict], module) -> None:
    """The traffic's sampler blocks, by the port's public class names; a
    Gibbs block's function is found by name in the model's module."""
    blocks = []
    for s in specs:
        cls = getattr(mt, s["sampler"])
        if "fn" in s:
            blocks.append(cls(s["params"], getattr(module, s["fn"])))
        else:
            blocks.append(cls(s["params"], **s.get("args", {})))
    model.set_samplers(blocks)


def warm_start(mt, adapter, config, traffic, data, inits, seed, device, dtype):
    """ADVI on the build the warm start names, then one draw from q for
    each chain, as ``bench.py`` warm-starts its chains."""
    from mamba_tpu_torch.ops import random as R
    ws = traffic["warm_start"]
    model, inputs, inits_w, module = adapter.build(config, data, ws["likelihood"])
    set_samplers(mt, model, traffic["samplers"], module)
    fit = mt.advi(model, inputs, inits_w[0], steps=ws["steps"], nmc=ws["nmc"],
                  seed=seed, device=device, dtype=dtype)
    draws = {k: v.cpu().numpy() for k, v in
             fit.sample(R.key(seed + 1, device), traffic["chains"]).items()}
    return [dict(inits[0], **{k: d[i] for k, d in draws.items()})
            for i in range(traffic["chains"])]


def run(man, cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float | None = None, log=print,
        overrides: dict | None = None):
    """Run the cell once; returns ``(result, checks, run)``: the result's
    keys but the checks, every number compared beside its limit, and the
    record the readers read.  ``overrides`` (tests only) replaces keys of
    the configuration and the traffic."""
    t_start = time.perf_counter() if t_start is None else t_start
    import mamba_tpu_torch as mt
    cell = man.cell(cell_name)
    config = {**man.config(cell["config"]), **(overrides or {}).get("config", {})}
    traffic = {**man.traffic(cell["traffic"]), **(overrides or {}).get("traffic", {})}
    ref, adapter = man.reference(cell["config"]), man.adapter(cell["config"])
    dtype = getattr(torch, config["dtype"])
    C, burnin = traffic["chains"], traffic["burnin"]
    spans: dict[str, float] = {}

    data = ref.make_data(config, seed)
    model, inputs, inits, module = adapter.build(config, data, traffic["likelihood"])
    if traffic.get("inits") is not None:
        inits = [inits[i] for i in traffic["inits"]]
    set_samplers(mt, model, traffic["samplers"], module)
    if traffic.get("warm_start"):
        with _clock(spans, "advi_s", device):
            inits = warm_start(mt, adapter, config, traffic, data, inits, seed,
                               device, dtype)
    with _clock(spans, "warmup_s", device):
        sim = mt.mcmc(model, inputs, inits, burnin + 1, burnin=burnin,
                      chains=C, seed=seed, verbose=False, device=device,
                      dtype=dtype)
    peak = _peak(device)
    k0 = traffic["calibration_iters"]
    t0 = time.perf_counter()
    sim = mt.mcmc(sim, k0, verbose=False)
    t_cal = time.perf_counter() - t0
    peak = max(peak, _peak(device))
    capture = sim.timing.get("capture_s", 0.0)
    per_iter = max(t_cal - capture, 1e-9) / k0
    K = max(MIN_WINDOW_ITERS, int((seconds - capture) / per_iter))
    params = traffic["samplers"][0]["params"]
    start = {n: sim.states["state"][n].clone() for n in params}
    _sync(device)
    spans["setup_s"] = time.perf_counter() - t_start

    plain_iters = K - traffic["profile_iters"] if trace else K
    t0 = time.perf_counter()
    sim = mt.mcmc(sim, plain_iters, verbose=False)
    plain_s = time.perf_counter() - t0
    plain = {"iters": plain_iters, "seconds": plain_s, "timing": sim.timing,
             "tunes": sim.states["tunes"]}
    peak = max(peak, _peak(device))
    sl = None
    if trace:
        from benchmark.trace import Slice, profiled
        kb = traffic["profile_iters"]
        t0 = time.perf_counter()
        sim, events = profiled(lambda s=sim: mt.mcmc(s, kb, verbose=False))
        plain_s += time.perf_counter() - t0
        peak = max(peak, _peak(device))
        sl = Slice(events)
    window_s = plain_s

    labels = list(config["monitored"])
    draws = np.asarray(sim.value)[-K:][:, [sim.names.index(l) for l in labels], :]
    ess = fe.ess_bulk(draws)
    ess_plain = fe.ess_bulk(draws[:plain_iters]) if trace else ess
    rhat = fe.rhat_rank(draws)
    attempted, failed = check.attempted_failed(ref, labels, draws)
    log(f"window: K {K} iterations x {C} chains in {window_s:.4f} s "
        f"(calibration {k0} in {t_cal:.4f} s, capture {capture:.4f} s); "
        f"replays {plain['timing'].get('replays')}, graphs "
        f"{plain['timing'].get('graphs')}, capture_s "
        f"{plain['timing'].get('capture_s')}, host_tests "
        f"{plain['timing'].get('host_tests')}")
    log("window bulk ESS " + ", ".join(f"{l} {e:.1f}" for l, e in zip(labels, ess))
        + "; rank R-hat " + ", ".join(f"{l} {r:.5f}" for l, r in zip(labels, rhat)))
    log("spans " + ", ".join(f"{k} {v:.4f}" for k, v in spans.items()))

    prog = check.ProgramSide(sim, params, ref.STATE_SITES, start, labels, draws)
    del sim, start
    ok, checks = check.judge(ref, data, prog, traffic["limits"], device,
                             traffic["check_chain_block"])
    record = Run(cell=cell, config=config, traffic=traffic, reference=ref,
                 chains=C, iters=K, window_s=window_s, spans=spans,
                 ess_min=float(np.min(ess)),
                 ess_min_plain=float(np.min(ess_plain)), plain=plain, slice=sl,
                 data=data, prog=prog)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in man.metrics(kind, cell_name):
        v = man.reader(m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if sl is not None:
        dev["busy_s"] = sl.busy_s
        dev["window_s"] = sl.window_s
        result["breakdown"] = sl.breakdown()
    return result, checks, record
