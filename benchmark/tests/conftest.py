"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need an NVIDIA GPU carry the ``card`` marker and skip at run
time without one (the ``card`` fixture); on the chip:
``python -m pytest benchmark/tests -q -m card -n 0``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skipped at run time without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: runs on the chip")
    return "cuda"
