"""Run cells of the benchmark several times, one process a run, and
summarize their spread, as the bounds in ``BENCHMARK.json`` are set:

    python3 -m benchmark.sets --out chiprun_out/sets.jsonl \
        --runs rats-nuts:30:0:101,102,103 glmm10k-chees:30:1:201

Each ``--runs`` item is ``cell:seconds:trace:seed,seed,...``; the runs of
one item go in that order.  Every run's last line, exit code, wall and the
tail of its standard error are appended to ``--out``; then, for each cell
and metric, the median and the quartile spread (the distance between the
first and third quartiles by ``statistics.quantiles(values, n=4)``, over
the median) are printed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

from benchmark.manifest import ROOT


def one(cell: str, seconds: str, trace: str, seed: str, timeout: float) -> dict:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", cell,
           "--seed", seed, "--seconds", seconds, "--trace", trace]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = [x for x in out.splitlines() if x.strip()]
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return {"cell": cell, "seconds": float(seconds), "trace": int(trace),
            "seed": int(seed), "rc": rc, "wall_s": time.perf_counter() - t0,
            "result": last, "stderr_tail": err[-6000:]}


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--runs", nargs="+", required=True)
    p.add_argument("--timeout", type=float, default=1200)
    a = p.parse_args(argv)
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    recs = []
    for item in a.runs:
        cell, seconds, trace, seeds = item.split(":")
        for seed in seeds.split(","):
            r = one(cell, seconds, trace, seed, a.timeout)
            recs.append(r)
            with out.open("a") as f:
                f.write(json.dumps(r) + "\n")
            res = r["result"] or {}
            print(f"{cell} seed {seed} trace {trace}: rc {r['rc']} wall "
                  f"{r['wall_s']:.1f} s correct {res.get('correct')} "
                  + json.dumps({k: v["value"] for k, v in
                                res.get("metrics", {}).items()})
                  + " " + json.dumps({k: v["value"] for k, v in
                                      res.get("checks", {}).items()}),
                  flush=True)
            if r["rc"] != 0:
                print(r["stderr_tail"][-3000:], flush=True)
    by = defaultdict(list)
    for r in recs:
        for k, v in ((r["result"] or {}).get("metrics") or {}).items():
            by[(r["cell"], r["trace"], k)].append(v["value"])
    for (cell, trace, k), vs in sorted(by.items()):
        if len(vs) >= 2:
            print(f"{cell} trace {trace} {k}: n {len(vs)} median "
                  f"{statistics.median(vs)!r} spread {spread(vs)!r} "
                  f"values {vs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
