"""The benchmark's own tests (python -m pytest portbench/tests).  Tests
marked `card` need an NVIDIA GPU; the `cuda_card` fixture skips them
without one (decided when the test runs, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card "
                    "(python -m pytest portbench/tests -m card)")
    return torch.device("cuda", 0)
