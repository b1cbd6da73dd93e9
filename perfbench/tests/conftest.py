"""Fixtures of the benchmark's own tests.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where torch sees no CUDA device; the decision is
made when the test runs, never while this module is imported.
"""
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.fixture
def checkout(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ (without its tests): what a
    later change adds files to."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return tmp_path
