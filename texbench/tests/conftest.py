"""Tests of the benchmark itself (run them with
``python -m pytest texbench/tests -q``; the repository's ``pytest tests/``
does not collect them). Tests that need the card carry the ``card``
marker and take the ``card`` fixture, which skips them where torch sees
no CUDA device."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is available")
    return "cuda"
