"""pytest settings of the benchmark's tests: the ``card`` marker for tests
that need a CUDA card, and the fixture that skips them without one. The
card is looked for inside the fixture, never at import or collection."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `python3 -m pytest portbench/tests -m card` there")
    return torch.device("cuda")
