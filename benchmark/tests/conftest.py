"""Tests of the benchmark.  Run from the checkout's root:

    python -m pytest benchmark/tests            # CPU; the card's tests skip
    python -m pytest -m cuda benchmark/tests    # on a CUDA machine
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, never
    at import time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
