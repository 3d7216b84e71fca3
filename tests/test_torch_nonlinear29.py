"""The port's algo/nonlinear.py against the JAX package's on the logp=29
chain (the u32 NTT's chain), at logn=6/logq=400/slots=4/Delta=2^30 (see
test_torch_nonlinear.py, which holds the checks and runs them on the 59-bit
chain).
"""

import pytest
import torch

from test_torch_nonlinear import OPS, both_runs, check_bit_equal

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return both_runs(29)


@pytest.mark.parametrize("name", OPS)
def test_nonlinear_bit_equal_logp29_chain(runs, name):
    check_bit_equal(runs, name)
