"""Tests of the benchmark. Tests that need a CUDA card carry the ``card``
marker and skip, inside a fixture, where there is none; run them on a
machine with one H100 with ``python3 -m pytest perfbench/tests -m card``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _card_or_skip(request):
    if request.node.get_closest_marker("card") is not None:
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
