"""The benchmark's own tests: they run on the CPU at toy sizes, apart from
those marked ``cuda``, which need the card and skip without one.

    python -m pytest perfbench/tests -q            # here
    python -m pytest perfbench/tests -q -m cuda    # on the card
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
