"""Tests of the benchmark harness.  Run from the repo root:

    python -m pytest avcbench/tests -q -n 4

Tests marked ``card`` need a CUDA card and skip without one; on the
machine with the card: ``python -m pytest avcbench/tests -q -m card``.
"""
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
# the plain kernels of several test workers share the host's cores
torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
