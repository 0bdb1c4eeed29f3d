"""Tests of the benchmark's harness (CPU unless marked ``cuda``):

    python -m pytest bench_port/tests -q            # the CPU tests
    python -m pytest bench_port/tests -q -m cuda    # on a card
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, not while
    the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
