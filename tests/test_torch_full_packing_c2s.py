"""Full-packing coeff2slot on the port, against the reference's DFT
construction and the JAX package (tests/test_bootstrap.py::
test_full_packing_c2s, slow there).

logn=5/q=2^400/slots=16 (= n/2, gap 1: the one regime in which the
reference's U construction is a valid DFT, and SubSum is empty), on the
default 59-bit chain and on logp=29.  Gates: BootstrapContext.U0 / U1
within 1e-9 of the reference construction; both coeff2slot outputs decode
within 1e-5 to the real and imaginary encode coefficients; every hoisted
plan without a fallback; on the 59-bit chain ct0 and ct1 bit-equal to the
JAX package's from the same Surf() stream.  The case is torch_cases.py's
c2s_packing_case, which tests/test_torch_cuda.py runs on the card.
"""

import pytest
import torch

from torch_cases import c2s_packing_case
from test_torch_full_packing import JAX_API, assert_bit_equal

torch.set_num_threads(1)

_port = {}


def port_case(logp):
    if logp not in _port:
        _port[logp] = c2s_packing_case(logp, device="cpu")
    return _port[logp]


@pytest.mark.parametrize("logp", [59, 29])
def test_full_packing_c2s(logp):
    r = port_case(logp)
    assert r["u_diff"] < 1e-9
    assert max(r["diffs"]) < 1e-5, r["diffs"]
    assert r["fallbacks"] and not any(r["fallbacks"].values())


@pytest.mark.parametrize("half", ["ct0", "ct1"])
def test_full_packing_c2s_bit_equal_to_jax(half):
    if "jax" not in _port:
        _port["jax"] = c2s_packing_case(59, api=JAX_API)
    j, t = _port["jax"], port_case(59)
    assert j["fallbacks"] == t["fallbacks"]
    assert_bit_equal(j[half], t[half])
