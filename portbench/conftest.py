"""The benchmark's tests: ``python -m pytest portbench/tests``.  Tests that
need a CUDA card carry the ``card`` marker and decide inside the test,
through the ``cuda_card`` fixture, whether one is there; without it they
skip."""

import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs on an H100; skips "
        "elsewhere)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Two torch threads a test process: the tiny models gain nothing from
    more, and several test workers share the machine's cores."""
    import torch

    torch.set_num_threads(min(2, os.cpu_count() or 1))
