"""Tests of the benchmark harness (run from the repository root:
`python -m pytest bench_h100/tests`). Tests that need an NVIDIA card carry
the `cuda` marker and skip themselves without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips itself without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs at the cell's "
                    "size on the card)")
    return torch.device("cuda", 0)
