import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped where there is none")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
