"""Tests of the benchmark.  Cases that need the card carry the ``card``
marker and take the ``card`` fixture, which skips them where no CUDA
device is visible; on the card they run with ``python -m pytest
gpubench/tests -m card``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA H100 (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.cuda.get_device_name(0)
