"""On the chip: the control at a cell's own size, one seed; skipped
without a CUDA device."""

import pytest

from benchmark.control import readings
from benchmark.manifest import Manifest


@pytest.mark.card
def test_the_control_fails_at_the_cells_size(card):
    r = readings(Manifest(), "glmm10k-chees", 2**31 + 17, 5.0, card,
                 log=lambda *a: None)
    lim = r["limits"]
    assert r["correct"] and all(r["program"][k] <= lim[k] for k in r["program"])
    assert any(r["control"][k] > lim[k] for k in r["control"])
