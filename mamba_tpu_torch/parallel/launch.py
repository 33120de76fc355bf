"""Start the ranks of a process group as subprocesses and wait for them.

One process per rank, as ``torchrun`` would start them, for callers that
start a group from Python: ``graft_entry.dryrun_multichip``, the
multi-process tests, ``scripts/bench_scaling.py --mode mesh`` and the
smoke test's two-rank phase.  The ranks meet at a ``file://`` rendezvous
in a fresh temporary directory.  Every rank runs under one deadline; when a
rank fails or the deadline passes the others are killed, since a rank that
waits on a dead peer's collective would wait until its own timeout.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: the root of the checkout, put on the ranks' PYTHONPATH
ROOT = Path(__file__).resolve().parents[2]


def run_ranks(argv_of_rank, n: int, *, timeout: float,
              env: dict | None = None) -> list[str]:
    """Run ``argv_of_rank(rank, init_method)`` for ranks 0..n-1 at once and
    return each rank's standard output.  Raises ``RuntimeError`` with the
    failed ranks' output if any rank exits non-zero, and ``TimeoutError``
    if they have not all ended after ``timeout`` seconds; no rank outlives
    the call."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init = f"file://{tmp}/rendezvous"
        outs = [open(Path(tmp) / f"rank{r}.out", "w+") for r in range(n)]
        errs = [open(Path(tmp) / f"rank{r}.err", "w+") for r in range(n)]
        procs = []
        try:
            for r in range(n):
                procs.append(subprocess.Popen(
                    [str(a) for a in argv_of_rank(r, init)], stdout=outs[r],
                    stderr=errs[r], stdin=subprocess.DEVNULL, env=env))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            timed_out = any(p.poll() is None for p in procs)
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        text = []
        for f in outs + errs:
            f.seek(0)
            text.append(f.read())
            f.close()
    stdout, stderr = text[:n], text[n:]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    report = "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                       f"{stdout[r][-4000:]}\n{stderr[r][-8000:]}"
                       for r in failed)
    if timed_out:
        raise TimeoutError(f"{n} ranks did not end within {timeout} s; "
                           f"killed\n{report}")
    if failed:
        raise RuntimeError(f"ranks {failed} of {n} failed\n{report}")
    return stdout


def python_module(module: str, *args) -> list[str]:
    """argv that runs ``module`` with this interpreter."""
    return [sys.executable, "-m", module, *map(str, args)]
