"""pytest settings of the benchmark's own tests (portbench/tests): the card
marker. Whether a card is present is decided inside the `cuda_device`
fixture, never while a module is imported. No JAX here.

    python3 -m pytest -p no:cacheprovider portbench/tests          # on the CPU; card tests skip
    python3 -m pytest -p no:cacheprovider portbench/tests -m cuda  # on a card
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
