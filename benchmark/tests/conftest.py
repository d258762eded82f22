"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository root (not collected by the repository's ``pytest tests/``).
Tests marked ``cuda`` need the card and skip without one; on the card:
``python3 -m pytest benchmark/tests -q -m cuda``."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def manifest():
    from harness.manifest import Manifest
    return Manifest()
