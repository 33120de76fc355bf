#!/usr/bin/env python3
"""Times builds of the fused GLMM kernel against each other on one CUDA card.

    python3 -m mamba_tpu_torch.scripts.glmm_kernel_lab \\
        --variant new --variant old:build/lab/fused_glmm_old.cu

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit.  A variant is ``NAME[:SOURCE]``: a source with the
``fused_glmm_scratch_floats`` and ``fused_glmm_loglik_grads`` functions of
``mamba_tpu_torch/csrc/fused_glmm.cu`` (that file when SOURCE is left out),
which the script compiles itself, with the package's flags, into
``build/lab/lib<NAME>.so``.  An earlier version of the kernel is timed by
writing it out of git first, for example
``git show <commit>:mamba_tpu_torch/csrc/fused_glmm.cu > build/lab/fused_glmm_old.cu``;
an ablation (another tile size, an accurate ``log1pf``) is an edited copy of
the source under ``build/lab``.

For every variant the script prints what ptxas reports, holds the kernel
against the float64 plain version on random inputs and on the near-mode
inputs (``glmm_cases.near_mode_inputs``) at the given shape, checks that
two launches agree bit for bit, and then times all variants and the float32
plain version in turns inside this one process: plain, v1 .. vk, vk .. v1,
plain; CUDA events around ``--reps`` launches after a warm-up, outputs
allocated beforehand.  The inputs and outputs of one call exceed the L2
cache at the default shape, so back-to-back launches find them cold.  The
card's name, power limit and clocks are printed beside the times, and the
bound from ``ops.fused_glmm.glmm_bound_ms``.  ``--sass`` also writes each
library's SASS to the ``--out`` directory (``build/lab`` unless given) and
prints the instruction count of each kernel.  Results go to standard output
and ``glmm_kernel_lab.json`` in that directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from ..ops import fused_glmm as fg
from .glmm_cases import glmm_errors, near_mode_inputs, random_inputs

LAB_DIR = fg.BUILD_DIR / "lab"


def _smi(fields):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _event_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Variant:
    def __init__(self, spec):
        name, _, src = spec.partition(":")
        self.name = name
        self.src = Path(src) if src else fg._SRC
        self.lib_path = LAB_DIR / f"lib{name}.so"
        self.lib = None

    def build(self):
        """Compile and load the variant; returns ptxas' resource lines."""
        self.lib_path.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([fg._nvcc(), *fg.NVCC_FLAGS, "-o",
                              str(self.lib_path), str(self.src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{self.name}: nvcc failed:\n{res.stderr}")
        self.lib = ctypes.CDLL(str(self.lib_path))
        self.lib.fused_glmm_scratch_floats.argtypes = [ctypes.c_int] * 3
        self.lib.fused_glmm_scratch_floats.restype = ctypes.c_longlong
        self.lib.fused_glmm_loglik_grads.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        self.lib.fused_glmm_loglik_grads.restype = ctypes.c_int
        return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                if "ptxas" in ln and ("registers" in ln or "Compiling" in ln
                                      or "spill" in ln)]

    def launcher(self, torch, args):
        """A function that launches this variant on ``args`` into outputs
        allocated here, and those outputs."""
        Xt, y, betas, bs = args
        P, n, G = Xt.shape
        C = betas.shape[0]
        f32 = dict(dtype=torch.float32, device=Xt.device)
        lp, gbeta, gb = (torch.empty(C, **f32), torch.empty(C, P, **f32),
                         torch.empty(C, G, **f32))
        scratch = torch.empty(self.lib.fused_glmm_scratch_floats(P, G, C), **f32)
        ptrs = [t.data_ptr() for t in (*args, lp, gbeta, gb, scratch)]
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = self.lib.fused_glmm_loglik_grads(*ptrs, P, n, G, C, stream)
            if err != 0:
                raise RuntimeError(f"{self.name}: cudaError {err}")

        return launch, (lp, gbeta, gb)

    def sass(self, out_dir):
        res = subprocess.run(["cuobjdump", "-sass", str(self.lib_path)],
                             capture_output=True, text=True, check=True)
        (out_dir / f"{self.name}.sass").write_text(res.stdout)
        counts, name = {}, None
        for ln in res.stdout.splitlines():
            if "Function :" in ln:
                name = ln.split("Function :")[1].strip()
                counts[name] = {"instructions": 0, "MUFU": 0, "SHFL": 0,
                                "LDS": 0, "STS": 0}
            elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", ln):
                counts[name]["instructions"] += 1
                for op in ("MUFU", "SHFL", "LDS", "STS"):
                    counts[name][op] += f" {op}" in ln
        return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--groups", type=int, default=10_000)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--P", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", type=Path, default=LAB_DIR)
    a = ap.parse_args(argv)
    a.out.mkdir(parents=True, exist_ok=True)

    import torch
    if not torch.cuda.is_available():
        print("glmm_kernel_lab: no CUDA device", file=sys.stderr)
        return 2
    P, n, G, C = a.P, a.n, a.groups, a.chains
    card = _smi("name,power.limit")
    clocks = _smi("clocks.sm,clocks.max.sm")
    max_hz = 1e6 * float(clocks.split(",")[1].split()[0])
    report = {"card": card, "clocks_sm_and_max": clocks,
              "shape": {"P": P, "n": n, "G": G, "C": C},
              "work": fg.glmm_work(P, n, G, C),
              "bound": fg.glmm_bound_ms(P, n, G, C, max_hz), "variants": {}}
    print(card, "|", clocks, flush=True)
    print("bound:", json.dumps(report["bound"]), flush=True)

    variants = [Variant(s) for s in a.variant]
    for v in variants:
        report["variants"][v.name] = {"source": str(v.src),
                                      "ptxas": v.build()}
        for ln in report["variants"][v.name]["ptxas"]:
            print(f"{v.name}: {ln}", flush=True)
        if a.sass:
            report["variants"][v.name]["sass"] = v.sass(a.out)
            print(f"{v.name} sass: {json.dumps(report['variants'][v.name]['sass'])}",
                  flush=True)

    def on_card(arrays):
        return tuple(torch.as_tensor(x, dtype=torch.float32, device="cuda")
                     for x in arrays)

    cases = {"random": random_inputs(P, n, G, C, a.seed)}
    if P == 4:
        cases["near_mode"] = near_mode_inputs(G, C, a.seed, n=n)
    for case, arrays in cases.items():
        args = on_card(arrays)
        # the same float32 inputs in float64, as chip_smoke.py's gates have it
        ref = fg.glmm_loglik_grads_plain(*(t.double() for t in args))
        plain_err = glmm_errors(fg.glmm_loglik_grads_plain(*args), ref)
        print(f"{case}: float32 plain version: {json.dumps(plain_err)}",
              flush=True)
        report[f"{case}_plain_float32"] = plain_err
        for v in variants:
            launch, out = v.launcher(torch, args)
            launch()
            torch.cuda.synchronize()
            first = [t.clone() for t in out]
            launch()
            torch.cuda.synchronize()
            err = glmm_errors(out, ref)
            err["reproducible"] = all(torch.equal(x, z)
                                      for x, z in zip(first, out))
            print(f"{case}: {v.name}: {json.dumps(err)}", flush=True)
            report["variants"][v.name][case] = err
        del ref

    args = on_card(cases["random"])
    launches = [v.launcher(torch, args)[0] for v in variants]
    plain = lambda: fg.glmm_loglik_grads_plain(*args)        # noqa: E731
    turns = [plain, *launches, *reversed(launches), plain]
    names = ["plain", *(v.name for v in variants),
             *(v.name for v in reversed(variants)), "plain"]
    for fn in turns[:len(variants) + 1]:
        fn()                                                 # warm-up
    torch.cuda.synchronize()
    times = {}
    for name, fn in zip(names, turns):
        times.setdefault(name, []).append(_event_ms(torch, fn, a.reps))
    bound = report["bound"]["bound_ms"]
    for name, ms in times.items():
        mean = sum(ms) / len(ms)
        line = {"ms_runs": ms, "ms": mean, "pct_of_bound": 100 * bound / mean}
        print(f"time: {name}: {json.dumps(line)}", flush=True)
        if name == "plain":
            report["plain"] = line
        else:
            report["variants"][name].update(line)
    print("clocks after:", _smi("clocks.sm,clocks.max.sm,power.draw"), flush=True)
    (a.out / "glmm_kernel_lab.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
