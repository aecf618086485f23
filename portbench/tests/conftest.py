"""Tests of the benchmark itself (`python -m pytest portbench/tests -q`).

Tests marked `cuda` need an NVIDIA GPU and skip without one; they decide so
inside the `cuda_device` fixture, never while a module is imported. The rest
run on the CPU at tiny sizes, where the port takes its plain PyTorch ops."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fusionmamba_torch.device import select_device
    return select_device("cuda")
