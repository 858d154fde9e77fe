"""Shared pieces of the benchmark's own tests (CPU, the plain route)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# small sizes for tiny runs of every cell on the CPU
TINY = {"dataset": {"length": 96, "n_train": 60, "n_test": 40},
        "pq": {"n_sub": 4, "codebook_size": 16}}
# a seed past 32 bits (seeds may be any whole number)
BIG_SEED = 2 ** 31 + 977


@pytest.fixture
def card():
    """Skips the test without a CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
