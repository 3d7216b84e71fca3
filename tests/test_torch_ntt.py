"""The port's NTT: the plain torch twin, the CUDA kernel's plan tables and
dispatch, and the kernel itself (on a GPU only).

The twin is held bit-equal to gpqhe_tpu.ops.ntt at logn=11, dim=3,
P in {1, 4} (test_torch_ntt_pallas.py holds it against the Pallas kernel).  The kernel's schedule (stage split, sub-block twiddle
indexing, lazy Shoup bounds) is modelled in Python-int arithmetic below and
held against the twin with a shrunken shared-memory size, so the global
stage pass is exercised here too; the CUDA source itself runs only on the
card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import ntt as jntt
from gpqhe_tpu.ops import ntt_pallas as ntp
from gpqhe_tpu.ops import rns as jrns

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import ntt as tntt
from gpqhe_tpu_torch.ops import ntt_cuda
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch
from gpqhe_tpu_torch.ring.poly import RingEngine

torch.set_num_threads(1)

LOGN, DIM = 11, 3
N = 1 << LOGN
MODES = ["fwd", "inv", "inv_scaled"]


@pytest.fixture(scope="module")
def rings():
    jp = JPolyContext(LOGN, q=1 << 54, dim_cap=DIM)
    tp = PolyContext(LOGN, q=1 << 54, dim_cap=DIM)
    return jp, jrns.make_basis_arrays(jp, DIM), RingEngine(tp, device="cpu")


def _rand(primes, shape, seed=7):
    rng = np.random.default_rng(seed)
    ps = np.array(primes, dtype=np.uint64)[:, None]
    return rng.integers(0, 1 << 62, shape, dtype=np.uint64) % ps


def _jax_ref(a, ba, mode):
    """gpqhe_tpu.ops.ntt under one jit (eager dispatch compiles every op)."""
    if mode == "fwd":
        return jax.jit(jntt.ntt)(a, ba.zetas, ba.ps, ba.pinv)
    scale = ba.ninvphat_mont if mode == "inv_scaled" else ba.ninv_mont
    return jax.jit(jntt.intt)(a, ba.zetas_inv, ba.ps, ba.pinv, scale)


def _twin(a, ba, mode):
    if mode == "fwd":
        return tntt.ntt(a, ba.zetas, ba.ps, ba.pinv)
    scale = ba.ninvphat_mont if mode == "inv_scaled" else ba.ninv_mont
    return tntt.intt(a, ba.zetas_inv, ba.ps, ba.pinv, scale)


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_butterfly(rings, P, mode):
    jp, jba, ring = rings
    shape = (P, DIM, N) if P > 1 else (DIM, N)
    a = _rand(jp.primes[:DIM], shape)
    ref = np.asarray(_jax_ref(jnp.asarray(a), jba, mode))
    got = torch_to_u64(_twin(u64_to_torch(a), ring.ba(DIM), mode))
    assert np.array_equal(ref, got)


def test_plan_tables_equal_pallas_plan(rings):
    jp, _, ring = rings
    R = N // 128
    tables = ntt_cuda.make_kernel_tables(ring.pctx, torch.device("cpu"))
    pplan = ntp.make_pallas_plan(jp, DIM)
    for d, pc in enumerate(jp.prime_ctx[:DIM]):
        p = int(pc.p)
        for mont, tw, tws, zb, zbs in (
                (pc.zetas, tables.tw_f, tables.tws_f, pplan.zbig_f, pplan.zbigs_f),
                (pc.zetas_inv, tables.tw_i, tables.tws_i, pplan.zbig_i, pplan.zbigs_i)):
            std, sh = ntp._to_std(mont, p), ntp._shoup(ntp._to_std(mont, p), p)
            assert np.array_equal(torch_to_u64(tw[d]), std)
            assert np.array_equal(torch_to_u64(tws[d]), sh)
            # the Pallas plan's lane-replicated big-stage rows hold the same words
            lo_hi = np.asarray(zb[d])[:, :R, 0].astype(np.uint64)
            assert np.array_equal(lo_hi[0] | (lo_hi[1] << np.uint64(32)), std[:R])
            lo_hi = np.asarray(zbs[d])[:, :R, 0].astype(np.uint64)
            assert np.array_equal(lo_hi[0] | (lo_hi[1] << np.uint64(32)), sh[:R])
    # scale constants: rows 3..6 of the Pallas scalar block are
    # (n^-1, companion, n^-1 phat^-1, companion)
    kplan = ntt_cuda.make_plan(ring.pctx, DIM, ring.ba(DIM), tables)
    scc = np.asarray(pplan.scc).astype(np.uint64)          # [dim, 2, 8, C]
    words = scc[:, 0, :, 0] | (scc[:, 1, :, 0] << np.uint64(32))
    assert np.array_equal(torch_to_u64(kplan.scale).T, words[:, 3:5])
    assert np.array_equal(torch_to_u64(kplan.scale_phat).T, words[:, 5:7])


@pytest.mark.parametrize("mode", MODES)
def test_cpu_dispatch_runs_the_twin(rings, mode):
    _, _, ring = rings
    a = u64_to_torch(_rand(ring.pctx.primes[:DIM], (2, DIM, N), seed=11))
    before = dict(ntt_cuda.LAUNCHES)
    plan = ring.ntt_plan(DIM)
    assert plan.tables is None          # a CPU ring builds no kernel tables
    if mode == "fwd":
        got = ntt_cuda.ntt(a, plan)
    else:
        got = ntt_cuda.intt(a, plan, scaled=mode == "inv_scaled")
    assert torch.equal(got, _twin(a, ring.ba(DIM), mode))
    assert ring.ntt_f(a, DIM).equal(ntt_cuda.ntt(a, plan))
    assert ntt_cuda.LAUNCHES == before


@pytest.mark.parametrize("n,dtype,match", [
    (1 << 3, torch.int64, "supports n"), (1 << 17, torch.int64, "supports n"),
    (3 << 4, torch.int64, "supports n"), (1 << 4, torch.int32, "int64"),
    (1 << 4, torch.int64, "CUDA tensors")])
def test_kernel_rejects_bad_calls(n, dtype, match):
    plan = ntt_cuda.NttPlan(DIM, n, None, None, None, None)
    with pytest.raises(ValueError, match=match):
        ntt_cuda.check_args(torch.zeros((DIM, n), dtype=dtype), plan)


def test_kernel_rejects_shape_mismatch():
    plan = ntt_cuda.NttPlan(DIM, 1 << 5, None, None, None, None)
    with pytest.raises(ValueError, match="does not match"):
        ntt_cuda.check_args(torch.zeros((DIM + 1, 1 << 5), dtype=torch.int64), plan)


# ---------------------------------------------------------------------------
# a Python-int model of csrc/ntt.cu's schedule
# ---------------------------------------------------------------------------

def _shoup(x, z, zs, p):
    q = (x * zs) >> 64
    r = (x * z - q * p) % (1 << 64)
    assert r < 2 * p
    return r


def _fwd_bf(x0, x1, z, zs, p):
    a = x0 - 2 * p if x0 >= 2 * p else x0
    t = _shoup(x1, z, zs, p)
    return a + t, a + 2 * p - t


def _inv_bf(x0, x1, z, zs, p):
    s = x0 + x1
    return (s - 4 * p if s >= 4 * p else s), _shoup(x0 + 4 * p - x1, z, zs, p)


def _stage(slab, loglen, tw, tws, p, inverse, scale=None):
    """ntt_stage_kernel on one slab (global-memory butterflies of span 2*len)."""
    n = len(slab)
    for i in range(n // 2):
        k = i >> loglen
        i0 = (k << (loglen + 1)) + (i & ((1 << loglen) - 1))
        i1 = i0 + (1 << loglen)
        zi = (n >> (loglen + 1)) + k
        bf = _inv_bf if inverse else _fwd_bf
        slab[i0], slab[i1] = bf(slab[i0], slab[i1], tw[zi], tws[zi], p)
        if scale is not None:
            slab[i0] = _shoup(slab[i0], *scale, p) % p
            slab[i1] = _shoup(slab[i1], *scale, p) % p
        assert slab[i0] < 4 * p and slab[i1] < 4 * p


def _smem(slab, logsub, tw, tws, p, inverse, finish, scale):
    """ntt_smem_kernel on every sub-block of one slab."""
    n = len(slab)
    m = 1 << logsub
    for c in range(n // m):
        sm = slab[c * m:(c + 1) * m]
        for s in range(logsub):
            loglen = s if inverse else logsub - 1 - s
            zoff = (n >> (loglen + 1)) + (c << (logsub - loglen - 1))
            for i in range(m // 2):
                k = i >> loglen
                i0 = (k << (loglen + 1)) + (i & ((1 << loglen) - 1))
                i1 = i0 + (1 << loglen)
                bf = _inv_bf if inverse else _fwd_bf
                sm[i0], sm[i1] = bf(sm[i0], sm[i1], tw[zoff + k], tws[zoff + k], p)
        if finish:
            sm = [_shoup(x, *scale, p) % p if inverse else x % p for x in sm]
        slab[c * m:(c + 1) * m] = sm


def _model_ntt(a, tw, tws, primes, scale, inverse, smem_logn):
    """gpqhe_ntt: a [nslab, n] Python ints, slab j on prime j % dim."""
    nslab, n = len(a), len(a[0])
    logn = n.bit_length() - 1
    logsub = min(logn, smem_logn)
    out = []
    for j in range(nslab):
        d = j % len(primes)
        p, slab = primes[d], list(a[j])
        args = (tw[d], tws[d], p)
        if not inverse:
            for loglen in range(logn - 1, logsub - 1, -1):
                _stage(slab, loglen, *args, False)
            _smem(slab, logsub, *args, False, True, None)
        else:
            _smem(slab, logsub, *args, True, logsub == logn, scale[d])
            for loglen in range(logsub, logn):
                _stage(slab, loglen, *args, True,
                       scale[d] if loglen == logn - 1 else None)
        out.append(slab)
    return out


@pytest.mark.parametrize("logn,smem_logn", [(6, 6), (7, 4), (5, 3)])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_schedule_model_matches_twin(logn, smem_logn, mode):
    dim = 2
    pctx = PolyContext(logn, q=1 << 118, dim_cap=dim)
    ring = RingEngine(pctx, device="cpu")
    tables = ntt_cuda.make_kernel_tables(pctx, torch.device("cpu"))
    plan = ntt_cuda.make_plan(pctx, dim, ring.ba(dim), tables)
    a = _rand(pctx.primes[:dim], (2, dim, 1 << logn), seed=logn)
    words = lambda t: [int(x) for x in torch_to_u64(t)]  # noqa: E731
    inverse = mode != "fwd"
    tw = [words(r) for r in (tables.tw_i if inverse else tables.tw_f)]
    tws = [words(r) for r in (tables.tws_i if inverse else tables.tws_f)]
    sc = torch_to_u64(plan.scale_phat if mode == "inv_scaled" else plan.scale)
    scale = [(int(sc[0, d]), int(sc[1, d])) for d in range(dim)]
    got = _model_ntt([[int(x) for x in row] for row in a.reshape(-1, 1 << logn)],
                     tw, tws, pctx.primes[:dim], scale, inverse, smem_logn)
    want = torch_to_u64(_twin(u64_to_torch(a), ring.ba(dim), mode))
    assert np.array_equal(np.array(got, dtype=np.uint64).reshape(a.shape), want)
