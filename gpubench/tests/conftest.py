"""Fixtures of the benchmark's own tests.  Tests that need a CUDA device
carry the `cuda` marker (registered in pyproject.toml) and take the `card`
fixture, which decides at run time whether there is one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest gpubench/tests -m cuda`")
    return torch.device("cuda", 0)
