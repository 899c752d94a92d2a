"""Tests of the benchmark harness: at tiny sizes on the CPU, and (marked
`chip`) at the cells' sizes on a CUDA device, where one is present.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their sizes on the card only")
    return torch.device("cuda")
