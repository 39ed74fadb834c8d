"""The benchmark's own tests: the manifest, the frozen arithmetic, each
driver at a tiny size on the CPU, the controls and the planted faults.

    python -m pytest port_bench/tests -q

Tests marked ``card`` need a CUDA device (they run the controls whose lower
precision only the card has); they decide in the ``card`` fixture and skip
elsewhere.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
