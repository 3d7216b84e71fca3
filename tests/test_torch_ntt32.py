"""The port's NTT on a logp=29 chain: the plain twin, the u32 CUDA kernel's
plan tables and dispatch, and a numpy-uint32 model of the kernel's schedule.

Over PolyContext(10, q=2^27, logp=29, dim_cap=3) the twin is held bit-equal
to gpqhe_tpu.ops.ntt under jax.jit in all three modes
(test_torch_ntt32_pallas.py holds it against ntt_pallas32 in interpret
mode).  csrc/ntt32.cu runs only on a GPU (tests/test_torch_cuda.py), so its
arithmetic is modelled here in numpy uint32, which wraps mod 2^32 exactly as
the card's words do: every butterfly is checked against Python-int
arithmetic at the lazy bounds (inputs up to 4p - 1, p just below 2^30), and
the whole schedule (stage split, sub-block twiddle indexing, 64-bit words in
device memory) is held against the twin with a shrunken shared-memory size,
so the global stage pass that n = 2^16 takes on the card runs here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import ntt as jntt
from gpqhe_tpu.ops import ntt_pallas as ntp
from gpqhe_tpu.ops import ntt_pallas32 as ntp32
from gpqhe_tpu.ops import rns as jrns

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import ntt as tntt
from gpqhe_tpu_torch.ops import ntt_cuda, ntt_cuda32
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch
from gpqhe_tpu_torch.ring.poly import RingEngine

torch.set_num_threads(1)

LOGN, DIM = 10, 3
N = 1 << LOGN
MODES = ["fwd", "inv", "inv_scaled"]
U32, U64 = np.uint32, np.uint64


@pytest.fixture(scope="module")
def rings():
    jp = JPolyContext(LOGN, q=1 << 27, logp=29, dim_cap=DIM)
    tp = PolyContext(LOGN, q=1 << 27, logp=29, dim_cap=DIM)
    return jp, jrns.make_basis_arrays(jp, DIM), RingEngine(tp, device="cpu")


def _rand(primes, shape, seed=7):
    rng = np.random.default_rng(seed)
    ps = np.array(primes, dtype=U64)[:, None]
    return rng.integers(0, 1 << 62, shape, dtype=U64) % ps


def _twin(a, ba, mode):
    if mode == "fwd":
        return tntt.ntt(a, ba.zetas, ba.ps, ba.pinv)
    scale = ba.ninvphat_mont if mode == "inv_scaled" else ba.ninv_mont
    return tntt.intt(a, ba.zetas_inv, ba.ps, ba.pinv, scale)


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_butterfly_on_30bit_chain(rings, P, mode):
    jp, jba, ring = rings
    assert max(jp.primes) < 1 << 30
    shape = (P, DIM, N) if P > 1 else (DIM, N)
    a = _rand(jp.primes[:DIM], shape)
    if mode == "fwd":
        ref = jax.jit(jntt.ntt)(jnp.asarray(a), jba.zetas, jba.ps, jba.pinv)
    else:
        scale = jba.ninvphat_mont if mode == "inv_scaled" else jba.ninv_mont
        ref = jax.jit(jntt.intt)(jnp.asarray(a), jba.zetas_inv, jba.ps, jba.pinv, scale)
    got = torch_to_u64(_twin(u64_to_torch(a), ring.ba(DIM), mode))
    assert np.array_equal(np.asarray(ref), got)


def _u32(t):
    assert t.dtype == torch.int32
    return t.numpy().view(U32)


def test_plan_tables_equal_pallas32_plan(rings):
    jp, _, ring = rings
    R = N // 128
    tables = ntt_cuda32.make_kernel_tables(ring.pctx, torch.device("cpu"))
    assert tables.word == 32
    pplan = ntp32.make_pallas32_plan(jp, DIM)
    for d, pc in enumerate(jp.prime_ctx[:DIM]):
        p = int(pc.p)
        assert int(_u32(tables.primes)[d]) == p
        for mont, tw, tws, zb, zbs in (
                (pc.zetas, tables.tw_f, tables.tws_f, pplan.zbig_f, pplan.zbigs_f),
                (pc.zetas_inv, tables.tw_i, tables.tws_i, pplan.zbig_i, pplan.zbigs_i)):
            std = ntp._to_std(mont, p)
            assert np.array_equal(_u32(tw)[d], std.astype(U32))
            assert np.array_equal(_u32(tws)[d], ntp32._shoup32_table(std, p))
            # the Pallas plan's lane-replicated big-stage rows hold the same words
            assert np.array_equal(np.asarray(zb)[d, :R, 0], _u32(tw)[d, :R])
            assert np.array_equal(np.asarray(zbs)[d, :R, 0], _u32(tws)[d, :R])
    # rows 3..6 of the Pallas scalar block: (n^-1, companion, n^-1 phat^-1, companion)
    kplan = ntt_cuda32.make_plan(ring.pctx, DIM, ring.ba(DIM), tables)
    scc = np.asarray(pplan.scc)[:, :, 0]                  # [dim, 8]
    assert kplan.scale[1].is_contiguous() and kplan.scale_phat[1].is_contiguous()
    assert np.array_equal(_u32(kplan.scale).T, scc[:, 3:5])
    assert np.array_equal(_u32(kplan.scale_phat).T, scc[:, 5:7])


def test_tables_reject_wide_primes():
    pctx = PolyContext(4, q=1 << 20, dim_cap=2)            # the 59-bit chain
    with pytest.raises(ValueError, match="primes < 2\\^30"):
        ntt_cuda32.make_kernel_tables(pctx, torch.device("cpu"))


def test_ring_selects_kernel_by_chain(rings):
    _, _, ring = rings
    assert ring.ntt_mod is ntt_cuda32
    wide = RingEngine(PolyContext(4, q=1 << 20, dim_cap=2), device="cpu")
    assert wide.ntt_mod is ntt_cuda
    # logp=30 primes exceed 2^30: 4p no longer fits the u32 word
    assert RingEngine(PolyContext(4, q=1 << 20, logp=30, dim_cap=2),
                      device="cpu").ntt_mod is ntt_cuda


@pytest.mark.parametrize("mode", MODES)
def test_cpu_dispatch_runs_the_twin(rings, mode):
    _, _, ring = rings
    a = u64_to_torch(_rand(ring.pctx.primes[:DIM], (2, DIM, N), seed=11))
    before = dict(ntt_cuda32.LAUNCHES32), dict(ntt_cuda.LAUNCHES)
    plan = ring.ntt_plan(DIM)
    assert plan.tables is None          # a CPU ring builds no kernel tables
    if mode == "fwd":
        got, via_ring = ntt_cuda32.ntt(a, plan), ring.ntt_f(a, DIM)
    else:
        scaled = mode == "inv_scaled"
        got = ntt_cuda32.intt(a, plan, scaled=scaled)
        via_ring = ring.ntt_i(a, DIM, scale_phatinv=scaled)
    assert torch.equal(got, _twin(a, ring.ba(DIM), mode))
    assert torch.equal(got, via_ring)
    assert (ntt_cuda32.LAUNCHES32, ntt_cuda.LAUNCHES) == before


def test_launch_rejects_cpu_tensor_and_wrong_word(rings):
    _, _, ring = rings
    tables = ntt_cuda32.make_kernel_tables(ring.pctx, torch.device("cpu"))
    plan = ntt_cuda32.make_plan(ring.pctx, DIM, ring.ba(DIM), tables)
    a = torch.zeros((DIM, N), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ntt_cuda32._launch(a, plan, False, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ntt_cuda._launch(a, plan, False, False)
    assert sum(ntt_cuda32.LAUNCHES32.values()) == 0


# ---------------------------------------------------------------------------
# a numpy-uint32 model of csrc/ntt32.cu
# ---------------------------------------------------------------------------

def _umulhi(a, b):
    return ((a.astype(U64) * b.astype(U64)) >> U64(32)).astype(U32)


def _shoup(x, z, zs, p):
    return x * z - _umulhi(x, zs) * p          # u32 arrays: wraps mod 2^32


def _csub(x, m):
    return np.where(x >= m, x - m, x)


def _fwd_bf(x0, x1, z, zs, p):
    a = _csub(x0, U32(2) * p)
    t = _shoup(x1, z, zs, p)
    return a + t, a + U32(2) * p - t


def _inv_bf(x0, x1, z, zs, p):
    a = _csub(x0, U32(2) * p)
    b = _csub(x1, U32(2) * p)
    return a + b, _shoup(a + U32(2) * p - b, z, zs, p)


def _scale_reduce(x, s, ss, p):
    return _csub(_shoup(x, s, ss, p), p)


def _bf_indices(half, loglen):
    i = np.arange(half)
    k = i >> loglen
    i0 = (k << (loglen + 1)) + (i & ((1 << loglen) - 1))
    return k, i0, i0 + (1 << loglen)


def _stage(slab, loglen, tw, tws, p, inverse, scale=None):
    """ntt32_stage_kernel on one slab of 64-bit words in device memory."""
    n = len(slab)
    k, i0, i1 = _bf_indices(n // 2, loglen)
    zi = (n >> (loglen + 1)) + k
    x0, x1 = slab[i0].astype(U32), slab[i1].astype(U32)
    x0, x1 = (_inv_bf if inverse else _fwd_bf)(x0, x1, tw[zi], tws[zi], p)
    if scale is not None:
        x0, x1 = _scale_reduce(x0, *scale, p), _scale_reduce(x1, *scale, p)
    slab[i0], slab[i1] = x0, x1


def _smem(slab, logsub, tw, tws, p, inverse, finish, scale):
    """ntt32_smem_kernel on every sub-block of one slab."""
    n = len(slab)
    m = 1 << logsub
    for c in range(n // m):
        sm = slab[c * m:(c + 1) * m].astype(U32)       # narrowed on load
        for s in range(logsub):
            loglen = s if inverse else logsub - 1 - s
            zoff = (n >> (loglen + 1)) + (c << (logsub - loglen - 1))
            k, i0, i1 = _bf_indices(m // 2, loglen)
            bf = _inv_bf if inverse else _fwd_bf
            sm[i0], sm[i1] = bf(sm[i0], sm[i1], tw[zoff + k], tws[zoff + k], p)
            assert int(sm.max()) < 4 * int(p)
        if finish:
            sm = (_scale_reduce(sm, *scale, p) if inverse
                  else _csub(_csub(sm, U32(2) * p), p))
        slab[c * m:(c + 1) * m] = sm                   # widened on store


def _model_ntt32(a, tw, tws, primes, scale, inverse, smem_logn):
    """gpqhe_ntt32: a u64[nslab, n], slab j on prime j % dim."""
    out = a.copy()
    logn = a.shape[1].bit_length() - 1
    logsub = min(logn, smem_logn)
    for j, slab in enumerate(out):
        d = j % len(primes)
        args = (tw[d], tws[d], primes[d])
        if not inverse:
            for loglen in range(logn - 1, logsub - 1, -1):
                _stage(slab, loglen, *args, False)
            _smem(slab, logsub, *args, False, True, None)
        else:
            _smem(slab, logsub, *args, True, logsub == logn, scale[d])
            for loglen in range(logsub, logn):
                _stage(slab, loglen, *args, True,
                       scale[d] if loglen == logn - 1 else None)
    return out


def _prime_below_2_30(n):
    """The largest prime p = 1 mod 2n below 2^30."""
    p = (1 << 30) - 2 * n + 1
    while not all(p % f for f in range(3, int(p ** 0.5) + 1, 2)):
        p -= 2 * n
    return p


@pytest.mark.parametrize("which", ["fwd", "inv"])
def test_model_butterflies_hold_the_lazy_bounds(which):
    """Inputs up to 4p - 1 with p just below 2^30 and just above 2^29: no u32
    word wraps, outputs stay below 4p and are right mod p."""
    rng = np.random.default_rng(3)
    for p in (_prime_below_2_30(16), (1 << 29) + 1 + 2 * 16 * 3):
        lim = 4 * p
        assert lim < 1 << 32
        edge = np.array([0, 1, p - 1, p, 2 * p - 1, 2 * p, 2 * p + 1, lim - 1], dtype=U64)
        x0 = np.concatenate([np.repeat(edge, len(edge)), rng.integers(0, lim, 4096, dtype=U64)])
        x1 = np.concatenate([np.tile(edge, len(edge)), rng.integers(0, lim, 4096, dtype=U64)])
        z = rng.integers(0, p, len(x0), dtype=U64)
        z[:3] = (0, 1, p - 1)
        zs = (z << U64(32)) // U64(p)
        bf = _fwd_bf if which == "fwd" else _inv_bf
        y0, y1 = bf(x0.astype(U32), x1.astype(U32), z.astype(U32), zs.astype(U32), U32(p))
        X0, X1, Z = x0.astype(object), x1.astype(object), z.astype(object)
        if which == "fwd":
            want0, want1 = (X0 + X1 * Z) % p, (X0 - X1 * Z) % p
        else:
            want0, want1 = (X0 + X1) % p, ((X0 - X1) * Z) % p
        assert np.array_equal(y0.astype(object) % p, want0)
        assert np.array_equal(y1.astype(object) % p, want1)
        assert int(y0.max()) < lim and int(y1.max()) < (lim if which == "fwd" else 2 * p)
        # the Shoup product of ANY u32 word is below 2p (exact high product)
        anyx = rng.integers(0, 1 << 32, len(z), dtype=U64).astype(U32)
        anyx[:2] = (0, 0xFFFFFFFF)
        r = _shoup(anyx, z.astype(U32), zs.astype(U32), U32(p))
        assert int(r.max()) < 2 * p
        assert np.array_equal(r.astype(object) % p, anyx.astype(object) * Z % p)


@pytest.mark.parametrize("logn,smem_logn", [(6, 6), (7, 4), (5, 3), (10, 9)])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_schedule_model_matches_twin(logn, smem_logn, mode):
    dim = 3
    pctx = PolyContext(logn, q=1 << 27, logp=29, dim_cap=dim)
    assert min(pctx.primes) > 1 << 29
    ring = RingEngine(pctx, device="cpu")
    tables = ntt_cuda32.make_kernel_tables(pctx, torch.device("cpu"))
    plan = ntt_cuda32.make_plan(pctx, dim, ring.ba(dim), tables)
    a = _rand(pctx.primes[:dim], (2, dim, 1 << logn), seed=logn)
    a[0, :, :4] = np.array(pctx.primes[:dim], dtype=U64)[:, None] - U64(1)   # p - 1
    a[1, :, :] = np.array(pctx.primes[:dim], dtype=U64)[:, None] - U64(1)
    inverse = mode != "fwd"
    tw = _u32(tables.tw_i if inverse else tables.tw_f)
    tws = _u32(tables.tws_i if inverse else tables.tws_f)
    sc = _u32(plan.scale_phat if mode == "inv_scaled" else plan.scale)
    scale = [(sc[0, d], sc[1, d]) for d in range(dim)]
    got = _model_ntt32(a.reshape(-1, 1 << logn), tw, tws, _u32(tables.primes),
                       scale, inverse, smem_logn)
    want = torch_to_u64(_twin(u64_to_torch(a), ring.ba(dim), mode))
    assert np.array_equal(got.reshape(a.shape), want)
