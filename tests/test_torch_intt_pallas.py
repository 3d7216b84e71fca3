"""The port's plain torch inverse NTT twin is bit-equal to the JAX package's
Pallas kernel in interpret mode, unscaled and scaled by n^-1 * phat^-1, at
logn=11, dim=3, P in {1, 4} (see test_torch_ntt_pallas.py).
"""

import pytest
import torch

from test_torch_ntt_pallas import check_twin_against_pallas

torch.set_num_threads(1)


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("mode", ["inv", "inv_scaled"])
def test_twin_matches_pallas_interpret_inverse(P, mode):
    check_twin_against_pallas(P, mode)
