"""The benchmark's own tests: `python -m pytest htbench/tests -q` from the
root of the repository, on the CPU (tiny cells through the port's plain
paths). Tests marked `card` need a CUDA device and skip without one; run
them on the card with `python -m pytest htbench/tests -q -m card`."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # as a run sets them: the port computes in float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
