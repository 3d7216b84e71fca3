"""The logp=9 debug chain (tests/test_crt_mode.py) on the port.

PolyContext(4, q=2^8, logp=9, dim_cap=6) has six primes of 10-11 bits
(577 ... 1153) at n=2^4.  Its largest prime is below 2^30, so the ring
serves it with the u32 kernel's binding (ring/poly.py::ntt_module): on the
CPU the plain twin, on the card csrc/ntt32.cu (tests/test_torch_cuda.py).
Decompose -> reconstruct(center=False) at every dim from dimub down to 1
must give the Python integers back and equal the JAX package's output bit
for bit; the NTT over primes[:3] must equal the JAX package's ops/ntt.py
forward output and come back to its input; and the u32 kernel's schedule
(csrc/ntt_passes.cuh, walked in numpy by tests/torch_ntt_schedule.py with
the u32 kernel's word arithmetic) must equal the twin on these primes in
all three modes: no lazy bound or Shoup companion of the kernel depends on
the primes being near 2^30.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import ntt as jntt
from gpqhe_tpu.ops import rns as jr

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import ntt_cuda32
from gpqhe_tpu_torch.ops import rns as tr
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch
from gpqhe_tpu_torch.ring.poly import RingEngine, ntt_module
from gpqhe_tpu_torch.substrate import bigint

from test_torch_ntt32 import MODES, _model32, _twin, _u32

torch.set_num_threads(1)

CHAIN = dict(q=1 << 8, logp=9, dim_cap=6)


@pytest.fixture(scope="module")
def ctxs():
    return JPolyContext(4, **CHAIN), PolyContext(4, **CHAIN)


def test_logp9_chain_selects_the_u32_kernel(ctxs):
    _, tp = ctxs
    assert tp.dimub == 6 and all(10 <= p.bit_length() <= 11 for p in tp.primes), tp.primes
    assert ntt_module(tp) is ntt_cuda32
    assert RingEngine(tp, device="cpu").ntt_mod is ntt_cuda32
    tables = ntt_cuda32.make_kernel_tables(tp, torch.device("cpu"))
    assert tables.word == 32 and tables.tw_f.dtype == torch.int32


@pytest.mark.parametrize("dim", [6, 5, 4, 3, 2, 1])
def test_crt_roundtrip_every_dim(ctxs, dim):
    jp, tp = ctxs
    b = tp.basis(dim)
    rnd = random.Random(21 + dim)
    vals = [rnd.randrange(b.P) for _ in range(tp.n)]
    vals[:3] = [0, 1, b.P - 1]
    k = bigint.nlimbs(b.P.bit_length())
    limbs = bigint.ints_to_limbs(vals, k)

    jba, jplan = jr.make_basis_arrays(jp, dim), jr.make_recon_plan(jp, dim)
    jw = jr.make_decomp_weights(jp, dim, k)
    jres = np.asarray(jax.jit(lambda x: jr.decompose(x, jba, jw))(jnp.asarray(limbs)))
    jback = np.asarray(jax.jit(functools.partial(jr.reconstruct, ba=jba, plan=jplan,
                                                 center=False))(jnp.asarray(jres)))

    tba, tplan = tr.make_basis_arrays(tp, dim, "cpu"), tr.make_recon_plan(tp, dim, "cpu")
    tw = u64_to_torch(tr.make_decomp_weights(tp, dim, k))
    res = tr.decompose(torch.from_numpy(limbs.astype(np.int64)), tba, tw)
    assert np.array_equal(torch_to_u64(res), jres)
    for d, p in enumerate(b.primes):
        assert [int(x) for x in torch_to_u64(res)[d]] == [v % p for v in vals]
    back = tr.reconstruct(res, tba, tplan, center=False).numpy()
    assert np.array_equal(back, jback.astype(np.int64))
    assert bigint.limbs_to_ints(back) == vals, f"dim={dim}"


def test_crt_ntt_small_primes():
    jp, tp = (JPolyContext(4, q=1 << 8, logp=9, dim_cap=3),
              PolyContext(4, q=1 << 8, logp=9, dim_cap=3))
    jba = jr.make_basis_arrays(jp, 3)
    ring = RingEngine(tp, device="cpu")
    rnd = random.Random(22)
    a = np.stack([np.array([rnd.randrange(p) for _ in range(16)], dtype=np.uint64)
                  for p in tp.primes[:3]])
    want = np.asarray(jax.jit(jntt.ntt)(jnp.asarray(a), jba.zetas, jba.ps, jba.pinv))
    hat = ring.ntt_f(u64_to_torch(a), 3)
    assert np.array_equal(torch_to_u64(hat), want)
    assert np.array_equal(torch_to_u64(ring.ntt_i(hat, 3)), a)


@pytest.mark.parametrize("mode", MODES)
def test_u32_kernel_schedule_on_the_logp9_chain(mode):
    """The u32 kernel's two passes on [2, 3, 16] residues of the 10-11-bit
    primes, inputs up to p - 1, against the twin."""
    pctx = PolyContext(4, q=1 << 8, logp=9, dim_cap=3)
    ring = RingEngine(pctx, device="cpu")
    tables = ntt_cuda32.make_kernel_tables(pctx, torch.device("cpu"))
    plan = ntt_cuda32.make_plan(pctx, 3, ring.ba(3), tables)
    tw = _u32(tables.tw_i if mode != "fwd" else tables.tw_f)[:3]
    sc = _u32(plan.scale_phat if mode == "inv_scaled" else plan.scale)
    ps = np.array(pctx.primes[:3], dtype=np.uint64)[:, None]
    a = np.random.default_rng(9).integers(0, 1 << 62, (2, 3, 16), dtype=np.uint64) % ps
    a[1] = ps - np.uint64(1)
    got = _model32(a, tw, _u32(tables.primes)[:3], sc, mode)
    assert np.array_equal(got, torch_to_u64(_twin(u64_to_torch(a), ring.ba(3), mode)))


def test_chip_smoke_case_on_the_cpu():
    """chip_smoke.py's logp=9 path (the suite phase runs it on the card):
    decompose, reconstruct and the NTT round trips exact at every dim."""
    from chip_smoke import crt_chain_case, crt_chain_ring
    ring = crt_chain_ring("cpu")
    assert ring.ntt_mod is ntt_cuda32
    out = crt_chain_case(ring)
    assert sorted(out) == [1, 2, 3, 4, 5, 6]
    assert all(all(v.values()) for v in out.values()), out
