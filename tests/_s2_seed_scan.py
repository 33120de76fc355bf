"""How often the line run's gates fail from one seed to another, on the CPU
(not a test; the counts are recorded in CHANGES.md).

    python tests/_s2_seed_scan.py mesh CHAINS      # seeds 0-19
    python tests/_s2_seed_scan.py quantiles        # seeds 0-9, both forms

Run from the root of a checkout (a copy of this file in another checkout
scans that one's port).  ``mesh``: the run of
``tests/test_torch_parallel.py::test_mesh_run_matches_the_reference_mesh_run``
(line under NUTS + Slice, 400/150, on the JAX package's 8-device mesh and
on the port's) at ``CHAINS`` chains and each seed; prints the seeds where
the mean / standard-deviation gates on every node fail, and those where
the test's gates (beta by mean and standard deviation, s2 by median and
interquartile range) fail.  ``quantiles``: the run of
``tests/test_torch_samplers_extra.py::test_slice_s2_posterior_matches_the_reference``
(line under AMWG + Slice, 256 chains, 600/200) at each seed; prints the
relative gaps of s2's quantiles between the packages.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.getcwd())

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import mamba_tpu as jmt  # noqa: E402
import mamba_tpu_torch as tmt  # noqa: E402
from mamba_tpu.models import line as jline  # noqa: E402
from mamba_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from mamba_tpu.samplers import AMWG as JAMWG, Slice as JSlice  # noqa: E402
from mamba_tpu_torch.models import line as tline  # noqa: E402
from mamba_tpu_torch.parallel import make_mesh  # noqa: E402


def _close(a, b, rtol, atol):
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def mesh(chains):
    old, new = [], []
    for seed in range(20):
        kw = dict(iters=400, burnin=150, chains=chains, seed=seed, verbose=False)
        jm, jin, jinits = jline.build()
        a = np.asarray(jmt.mcmc(jm, jin, jinits, mesh=jmake_mesh({"chains": 8}),
                                **kw).value)
        tm, tin, tinits = tline.build()
        b = tmt.mcmc(tm, tin, tinits, mesh=make_mesh(None, "cpu"), device="cpu",
                     **kw).value
        if not (_close(a.mean((0, 2)), b.mean((0, 2)), 0, 0.3)
                and _close(a.std((0, 2)), b.std((0, 2)), 0.5, 0.1)):
            old.append(seed)
        qa, qb = (np.quantile(v[:, 2], [0.25, 0.5, 0.75]) for v in (a, b))
        if not (_close(a[:, :2].mean((0, 2)), b[:, :2].mean((0, 2)), 0, 0.3)
                and _close(a[:, :2].std((0, 2)), b[:, :2].std((0, 2)), 0.5, 0.1)
                and _close(qa[1], qb[1], 0, 0.3)
                and _close(qa[2] - qa[0], qb[2] - qb[0], 0.5, 0.1)):
            new.append(seed)
        print(f"seed {seed}: mean/std gates fail at {old}, "
              f"the test's gates at {new}", flush=True)


def quantiles():
    q = [0.1, 0.25, 0.5, 0.75]
    for form in ("multivariate", "univariate"):
        for seed in range(10):
            kw = dict(burnin=200, chains=256, seed=seed, verbose=False)
            jm, jin, jinits = jline.build(chains=256, scheme="amwg_slice")
            jm.set_samplers([JAMWG("beta", np.ones(2)), JSlice("s2", 3.0, form=form)])
            a = np.asarray(jmt.mcmc(jm, jin, jinits, 600, **kw).value)
            tm, tin, tinits = tline.build(chains=256, scheme="amwg_slice")
            tm.set_samplers([tmt.AMWG("beta", np.ones(2)),
                             tmt.Slice("s2", 3.0, form=form)])
            b = tmt.mcmc(tm, tin, tinits, 600, device="cpu", **kw).value
            gap = np.abs(np.quantile(b[:, 2], q) / np.quantile(a[:, 2], q) - 1)
            print(form, seed, "relative gaps", gap.round(4).tolist(), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "mesh":
        mesh(int(sys.argv[2]))
    else:
        quantiles()
