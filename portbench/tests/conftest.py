"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository's root.  Tests marked ``gpu`` need the card and skip without
one (the ``card`` fixture decides, never an import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
