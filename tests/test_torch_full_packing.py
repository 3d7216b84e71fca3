"""Hoisted gemv at full packing and at a slot count that is not a square, on
the port, against the JAX package (tests/test_algo.py::
test_gemv_hoisted_slots256).

logn=9/logq=120/Delta=2^30 with slots=256 (= n/2, gap 1: n1=16, sixteen
giant steps, each streaming its own diagonal slab through
HoistedGemvPlan.pack_slab) and slots=8 (n1 = isqrt(2 slots) = 4, n2=2),
on the default 59-bit chain and on logp=29.  The rotation bank holds only
the baby steps and the giant-step multiples, so the streamed BSGS route
runs.  Gates: decode within 1e-5 of A @ m, plan.fallbacks == 0, and on the
59-bit chain the output ciphertext bit-equal to the JAX package's from the
same Surf() stream and numpy seed.  The case itself is torch_cases.py's
gemv_packing_case, which tests/test_torch_cuda.py runs on the card.
"""

import numpy as np
import pytest
import torch
from types import SimpleNamespace

import gpqhe_tpu
from gpqhe_tpu import bootstrap as jbs
from gpqhe_tpu.algo import linalg as jlin
from gpqhe_tpu.ring import sample as jsmp
from gpqhe_tpu.ring.canemb import invcanemb as jinvcanemb
from gpqhe_tpu.substrate.surf import Surf as JSurf

from gpqhe_tpu_torch.scheme.types import limbs_to_numpy

from torch_cases import gemv_packing_case

torch.set_num_threads(1)

JAX_API = SimpleNamespace(HeContext=gpqhe_tpu.HeContext, CKKS=gpqhe_tpu.CKKS, Surf=JSurf,
                          linalg=jlin, bootstrap=jbs, sample=jsmp, invcanemb=jinvcanemb)


def assert_bit_equal(j, t):
    """A JAX ciphertext and a port ciphertext: equal ledgers and limbs."""
    assert (j.l, j.nu, j.B) == (t.l, t.nu, t.B)
    assert np.array_equal(np.asarray(j.c0), limbs_to_numpy(t.c0))
    assert np.array_equal(np.asarray(j.c1), limbs_to_numpy(t.c1))


_port = {}


def port_case(logp, slots):
    if (logp, slots) not in _port:
        _port[logp, slots] = gemv_packing_case(logp, slots, device="cpu")
    return _port[logp, slots]


@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("slots,n1,n2", [(256, 16, 16), (8, 4, 2)])
def test_gemv_hoisted_packing(logp, slots, n1, n2):
    r = port_case(logp, slots)
    assert (r["n1"], r["n2"]) == (n1, n2)
    assert r["fallbacks"] == 0
    assert r["diff"] < 1e-5, r["diff"]
    assert sorted(r["rk"]) == sorted(set(range(n1)) | {i * n1 for i in range(n2)})


@pytest.mark.parametrize("slots", [256, 8])
def test_gemv_hoisted_packing_bit_equal_to_jax(slots):
    j = gemv_packing_case(59, slots, api=JAX_API)
    t = port_case(59, slots)
    assert j["fallbacks"] == t["fallbacks"] == 0
    assert_bit_equal(j["out"], t["out"])
    assert j["diff"] == t["diff"]
