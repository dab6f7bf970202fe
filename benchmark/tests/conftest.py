"""The benchmark's tests: CPU tests at a 4^3 mesh with the kernels' plain
versions, and tests marked ``card`` that need a CUDA card (they skip here;
on the card: ``python -m pytest benchmark/tests -m card``)."""

import os

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs the cells at full size)")
    # each of pytest-xdist's workers takes its share of the host's cores: a
    # worker that starts a thread a core beside the others slows every run
    # many times over (a 4^3 P2 run: 24 s alone, over 500 s with -n 4)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the full-size runs need the H100")
    return torch.device("cuda")
