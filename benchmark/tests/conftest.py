"""The benchmark's tests: CPU tests at a 4^3 mesh with the kernels' plain
versions, and tests marked ``card`` that need a CUDA card (they skip here;
on the card: ``python -m pytest benchmark/tests -m card``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs the cells at full size)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the full-size runs need the H100")
    return torch.device("cuda")
