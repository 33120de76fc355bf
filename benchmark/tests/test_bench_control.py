"""The control: the plain reference in bfloat16 put in the program's place
fails the check, while the program in float32 passes it, on several seeds
at a size the CPU holds (on the chip at the cells' own sizes:
``python3 -m benchmark.control``)."""

import pytest

from benchmark.control import readings
from benchmark.manifest import Manifest

from _tiny import TINY


@pytest.mark.parametrize("cell", ["glmm10k-chees", "glmm10k-chees-generic",
                                  "rats-nuts"])
def test_the_control_fails_and_the_program_passes(cell):
    man = Manifest()
    for seed in (1, 2, 2**31 + 3):
        r = readings(man, cell, seed, 0.1, "cpu", overrides=TINY[cell],
                     log=lambda *a: None)
        lim = r["limits"]
        assert r["correct"], r
        assert all(r["program"][k] <= lim[k] for k in r["program"]), r
        # the control fails the check; at this size the log-density and the
        # draws separate the two readings by 3 or more (the gradient's gap
        # grows with the data: 0.04 at 64 groups, 2.9 at the cell's 10,000)
        assert any(r["control"][k] > lim[k] for k in r["control"]), r
        for k in ("lp_gap", "draw_gap"):
            assert r["control"][k] > 3 * lim[k] > 3 * r["program"][k], (k, r)
