"""The benchmark's own tests: the CPU ones run here, the card ones (marked
``card``) skip where no CUDA device is present.  Run from the repository
root: ``python -m pytest slam_bench/tests -q``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100); none here")
    return torch.device("cuda")
