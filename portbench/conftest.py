"""pytest settings of the benchmark's own tests (`portbench/tests`).

Tests that need an NVIDIA card carry the `card` marker and take the
`card` fixture, which decides when the test runs, never at import,
whether a card is present.  Run them on the card with
`python3 -m pytest portbench/tests -m card`."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)
