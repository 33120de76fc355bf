"""The plain references against the port's block densities and gradients
at small sizes on the CPU, and the GLMM's data against the port's
generator."""

import numpy as np
import pytest

from benchmark import job
from benchmark.manifest import Manifest

from _tiny import TINY, with_dtype


def test_glmm_data_is_the_ports_generator():
    from mamba_tpu_torch.models import glmm
    man = Manifest()
    for seed in (0, 3, 2**31 + 7):
        cfg = {**man.config("glmm10k"), "G": 50, "data_seed": seed}
        data = man.reference("glmm10k").make_data(cfg, 12345)
        _, inputs, inits, _ = glmm.build(G=50, n=10, seed=seed, fused=False)
        np.testing.assert_array_equal(data["x"], inputs["x"])
        np.testing.assert_array_equal(data["y"], inits[0]["y"])


def test_rats_data_is_the_published_data():
    from mamba_tpu_torch.models import rats
    man = Manifest()
    data = man.reference("rats").make_data(man.config("rats"), 1)
    np.testing.assert_array_equal(data["y"], rats.Y)
    np.testing.assert_array_equal(data["x"], rats.X)


@pytest.mark.parametrize("cell", ["rats-nuts", "glmm10k-chees",
                                  "glmm10k-chees-generic"])
def test_reference_is_the_ports_density_in_float64(cell):
    res, checks, rec = job.run(Manifest(), cell, 11, 0.1, False, device="cpu",
                               log=lambda *a: None,
                               overrides=with_dtype(TINY[cell], "float64"))
    assert res["correct"], checks
    assert checks["lp_gap"]["value"] < 1e-13
    assert checks["grad_gap"]["value"] < 1e-11
    assert checks["draw_gap"]["value"] < 1e-13
    assert checks["unmoved"]["value"] == 0
    assert res["attempted"] == rec.chains * rec.iters and res["failed"] == 0
