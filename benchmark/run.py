"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``mamba_tpu_torch``).
The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then ``checks``, every number compared beside its limit,
which are also the last lines on standard error.  Exits 2 without a result
when there is no CUDA device or fewer than the cell needs, and 3 when JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark.manifest import ROOT, Manifest  # noqa: E402

#: top-level module names that the run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "mamba_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``mamba_tpu_torch`` is not ``mamba_tpu``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name, power limit and SM clock as ``nvidia-smi`` reads
    them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # every build and kernel cache of the run inside the checkout, at fixed
    # paths (the port builds its kernels into build/ itself)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    man = Manifest(ROOT)
    cell = man.cell(a.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"no result: the cell needs {cell['chips']} CUDA device(s), "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from benchmark import job
    result, checks, _ = job.run(man, a.workload, a.seed, a.seconds,
                                bool(a.trace), device="cuda", t_start=T_START,
                                log=log)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the run loaded {bad}")
        return 3
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
