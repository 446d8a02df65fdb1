"""The benchmark's own tests: CPU rehearsals at tiny size, and cases that
need a CUDA card (marker ``cuda``; they skip where there is none).

  python -m pytest benchmark/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on a card")
    return torch.device("cuda", 0)
