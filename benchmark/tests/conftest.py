"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root. Tests marked ``card`` need a CUDA card and skip without
one; whether there is one is decided in the ``card`` fixture, never while a
module is imported."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's cells run only there")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def tiny_root(tmp_path):
    import tiny
    return tiny.make_root(tmp_path)
