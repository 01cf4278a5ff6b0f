"""The benchmark's own tests (``python -m pytest perfbench/tests``): the
repository root on the path, and the ``cuda`` marker's fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA GPU where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels on the card)")
    return torch.device("cuda", 0)
