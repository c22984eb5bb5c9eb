"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of a checkout. Tests that need a CUDA card are marked ``cuda`` and
skip without one (decided inside the ``card`` fixture)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
