"""pytest settings of the benchmark's own tests (`python -m pytest proofbench`).

Tests marked `card` run only where a CUDA card is present; whether one is
is decided inside the `card` fixture, never while a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip: python -m pytest proofbench -m card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")
