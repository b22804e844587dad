"""Tests of the benchmark itself (not of the program): run here on the CPU
with ``python3 -m pytest benchmark/tests -q``; the card test (marker
``cuda``) runs on a machine with the H100 and skips elsewhere."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card test runs on the "
                    "H100 only")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path):
    """A harness.Bench over a tiny copy of the benchmark."""
    import helpers

    from benchmark import harness

    return harness.Bench(helpers.tiny_bench(str(tmp_path)))
