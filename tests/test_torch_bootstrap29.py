"""The port's bootstrap stages against the JAX package's on the logp=29
chain (the u32 NTT's chain), at logn=5/logq=220/slots=2/Delta=2^30 (see
test_torch_bootstrap.py, which holds the checks and runs them on the 59-bit
chain).
"""

import pytest
import torch

from test_torch_bootstrap import (CTS, both_runs, check_iter_too_small, check_plaintexts,
                                  check_stage)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return both_runs(29)


@pytest.mark.parametrize("name", CTS)
def test_stage_bit_equal_logp29_chain(runs, name):
    check_stage(runs, name)


def test_plaintexts_and_plans_logp29_chain(runs):
    check_plaintexts(runs)


def test_iter_too_small_raises_logp29_chain(runs):
    check_iter_too_small(runs)
