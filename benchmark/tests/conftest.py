"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

They run on the CPU; the few that need a CUDA card carry the ``gpu``
marker and skip without one (``card`` fixture).  The package under test
runs on its plain PyTorch path (``device="cpu"``) with torch on one
thread.
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skipped without one; on a card host: "
                   "python -m pytest benchmark/tests -m gpu)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
