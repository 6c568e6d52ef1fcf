"""Test settings of the benchmark's own tests (run from the repo's root:
``python -m pytest benchmark/tests``).  Tests that need a CUDA card carry
the ``card`` marker and skip, inside their fixture, where none is present."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one); run on the "
        "card with python3 -m pytest benchmark/tests -m card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
