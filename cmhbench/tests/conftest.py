"""Tests of the benchmark: ``python -m pytest cmhbench/tests -q``. Those
marked ``gpu`` need a CUDA card and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    return torch.device("cuda", 0)
