"""The port's plain torch NTT twin is bit-equal to the JAX package's
single-word Pallas kernel (ops/ntt_pallas32.py) on a logp=29 chain, run in
interpret mode on the CPU under jax.jit, at logn=10, dim=3, P in {1, 2}, in
all three modes.  The JAX package's own suite never ran that kernel; this
is the check that the kernel the u32 CUDA NTT replaces computes what the
twin computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import ntt_pallas32 as ntp32

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import ntt_cuda32
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch
from gpqhe_tpu_torch.ring.poly import RingEngine

torch.set_num_threads(1)

LOGN, DIM = 10, 3
N = 1 << LOGN


@pytest.fixture(scope="module")
def rings():
    return (JPolyContext(LOGN, q=1 << 27, logp=29, dim_cap=DIM),
            RingEngine(PolyContext(LOGN, q=1 << 27, logp=29, dim_cap=DIM),
                       device="cpu"))


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("mode", ["fwd", "inv", "inv_scaled"])
def test_twin_matches_pallas32_interpret(rings, P, mode):
    jp, ring = rings
    shape = (P, DIM, N) if P > 1 else (DIM, N)
    rng = np.random.default_rng(P)
    a = rng.integers(0, 1 << 62, shape, dtype=np.uint64) % \
        np.array(jp.primes[:DIM], dtype=np.uint64)[:, None]
    plan = ntp32.make_pallas32_plan(jp, DIM, P=P)
    pal = jax.jit(lambda x: ntp32.ntt_pallas32(x, plan, inverse=mode != "fwd",
                                               interpret=True,
                                               scaled=mode == "inv_scaled"))
    t = u64_to_torch(a)
    tplan = ring.ntt_plan(DIM)
    got = (ntt_cuda32.ntt(t, tplan) if mode == "fwd"
           else ntt_cuda32.intt(t, tplan, scaled=mode == "inv_scaled"))
    assert np.array_equal(np.asarray(pal(jnp.asarray(a))), torch_to_u64(got))
