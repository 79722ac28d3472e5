"""pytest settings of the benchmark's own tests (``benchmark/tests``): the
``card`` marker for tests that need a CUDA device, skipped without one.

    python -m pytest benchmark/tests -q          # CPU; the card tests skip
    python -m pytest benchmark/tests -q -m card  # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
