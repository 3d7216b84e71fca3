"""The port's plain torch NTT twin is bit-equal to the JAX package's Pallas
NTT kernel, run in interpret mode on the CPU as tests/test_pallas.py runs it
(here under jax.jit, which traces the interpreted kernel once instead of
dispatching it op by op), at logn=11, dim=3, P in {1, 4}.  This file holds
the forward transform; test_torch_intt_pallas.py the inverse and the
inverse scaled by n^-1 * phat^-1 (interpreting the kernel is slow, so the
two halves run as separate files).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import ntt_pallas as ntp

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import ntt as tntt
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch
from gpqhe_tpu_torch.ring.poly import RingEngine

torch.set_num_threads(1)

LOGN, DIM = 11, 3
N = 1 << LOGN


_RINGS = {}


def check_twin_against_pallas(P, mode):
    """The twin equals ntt_pallas(interpret=True) on one [P,] dim x n stack."""
    if not _RINGS:
        _RINGS["jax"] = JPolyContext(LOGN, q=1 << 54, dim_cap=DIM)
        _RINGS["torch"] = RingEngine(PolyContext(LOGN, q=1 << 54, dim_cap=DIM),
                                     device="cpu")
    jp, ring = _RINGS["jax"], _RINGS["torch"]
    shape = (P, DIM, N) if P > 1 else (DIM, N)
    rng = np.random.default_rng(P)
    a = rng.integers(0, 1 << 62, shape, dtype=np.uint64) % \
        np.array(jp.primes[:DIM], dtype=np.uint64)[:, None]
    plan = ntp.make_pallas_plan(jp, DIM, P=P)
    pal = jax.jit(lambda x: ntp.ntt_pallas(x, plan, inverse=mode != "fwd",
                                           interpret=True,
                                           scaled=mode == "inv_scaled"))
    ba = ring.ba(DIM)
    t = u64_to_torch(a)
    if mode == "fwd":
        got = tntt.ntt(t, ba.zetas, ba.ps, ba.pinv)
    else:
        got = tntt.intt(t, ba.zetas_inv, ba.ps, ba.pinv,
                        ba.ninvphat_mont if mode == "inv_scaled" else ba.ninv_mont)
    assert np.array_equal(np.asarray(pal(jnp.asarray(a))), torch_to_u64(got))


@pytest.mark.parametrize("P", [1, 4])
def test_twin_matches_pallas_interpret_forward(P):
    check_twin_against_pallas(P, "fwd")
