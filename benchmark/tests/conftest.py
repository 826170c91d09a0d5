"""The benchmark's tests import its library (``benchlib``) and the program
from the checkout's root; the card's tests skip without a card."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
