"""The port's NTT: the plain torch twin, the CUDA kernel's plan tables and
dispatch, and Python-int models of the kernel's schedules.

The twin is held bit-equal to gpqhe_tpu.ops.ntt at logn=11, dim=3,
P in {1, 4} (test_torch_ntt_pallas.py holds it against the Pallas kernel).
The CUDA source runs only on the card (tests/test_torch_cuda.py), so its
schedule is modelled here in Python-int arithmetic and held against the
twin: the two-pass kernels (csrc/ntt_passes.cuh) through
torch_ntt_schedule.schedule_model, which walks the index maps the .cu follows (column
and row tiles, register groups, exchanges, twiddle indices into the
interleaved table) with the lazy bounds asserted at every butterfly.
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

from torch_ntt_schedule import pass_geometry, schedule_model

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
    assert tables.tw_f.shape == tables.tw_i.shape == (ring.pctx.dimub, N, 2)
    assert tables.tw_f.is_contiguous() and tables.tw_i.is_contiguous()
    pplan = ntp.make_pallas_plan(jp, DIM)
    for d, pc in enumerate(jp.prime_ctx[:DIM]):
        p = int(pc.p)
        for mont, tw, zb, zbs in (
                (pc.zetas, tables.tw_f, pplan.zbig_f, pplan.zbigs_f),
                (pc.zetas_inv, tables.tw_i, pplan.zbig_i, pplan.zbigs_i)):
            std, sh = ntp._to_std(mont, p), ntp._shoup(ntp._to_std(mont, p), p)
            # interleaved pairs: [..., 0] the twiddle, [..., 1] its companion
            assert np.array_equal(torch_to_u64(tw[d, :, 0]), std)
            assert np.array_equal(torch_to_u64(tw[d, :, 1]), sh)
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
# Python-int arithmetic of csrc/ntt.cu
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


# ---------------------------------------------------------------------------
# the two-pass schedule (csrc/ntt_passes.cuh) on Python ints
# ---------------------------------------------------------------------------

def _checked(bf):
    """A scalar butterfly on object arrays, inputs and outputs held < 4p."""
    def one(x0, x1, z, zs, p):
        assert x0 < 4 * p and x1 < 4 * p and z < p
        y0, y1 = bf(x0, x1, z, zs, p)
        assert y0 < 4 * p and y1 < 4 * p
        return y0, y1
    return np.frompyfunc(one, 5, 2)


class Arith64:
    """csrc/ntt.cu's device functions on numpy object arrays of Python ints."""
    dtype = object
    fwd_bf = staticmethod(_checked(_fwd_bf))
    inv_bf = staticmethod(_checked(_inv_bf))
    load = staticmethod(lambda w: w)
    scale_reduce = staticmethod(np.frompyfunc(
        lambda x, s, ss, p: (lambda r: r - p if r >= p else r)(_shoup(x, s, ss, p)), 4, 1))
    final_reduce = staticmethod(np.frompyfunc(lambda x, p: x % p if x < 4 * p else None, 2, 1))


def _plan_words(logn, dim, mode, q=1 << 20):
    pctx = PolyContext(logn, q=q, dim_cap=dim)
    ring = RingEngine(pctx, device="cpu")
    tables = ntt_cuda.make_kernel_tables(pctx, torch.device("cpu"))
    plan = ntt_cuda.make_plan(pctx, dim, ring.ba(dim), tables)
    tw = torch_to_u64(tables.tw_i if mode != "fwd" else tables.tw_f).astype(object)
    sc = torch_to_u64(plan.scale_phat if mode == "inv_scaled" else plan.scale).astype(object)
    return pctx, ring, tw[:dim], np.array(pctx.primes[:dim], dtype=object), sc


# (logn, overrides of the kernel's split / tiles / groups); {} is the kernel's own
PASS_CASES = [
    (4, {}), (6, {}), (8, {}),                               # one pass, small n
    (7, {"groups": {7: (3, 2, 2)}}), (7, {"groups": {7: (2, 3, 2)}, "row_seqs": 2}),
    (9, {}), (10, {}),                                       # 2^5 * 2^4 (odd), 2^5 * 2^5
    (9, {"split": (4, 5), "col_seqs": 8, "row_seqs": 4}),
    (11, {"split": (7, 4), "col_seqs": 4, "row_seqs": 16}),  # 7 = 3+2+2 in the column pass
    (11, {"split": (4, 7), "col_seqs": 16, "row_seqs": 1, "groups": {7: (3, 3, 1), 4: (3, 1)}}),
    (12, {"split": (8, 4), "col_seqs": 2}),                  # 8 = 3+3+2
]


@pytest.mark.parametrize("logn,over", PASS_CASES, ids=lambda v: str(v).replace(" ", ""))
@pytest.mark.parametrize("mode", MODES)
def test_two_pass_model_matches_twin(logn, over, mode):
    dim = 2
    pctx, ring, tw, primes, sc = _plan_words(logn, dim, mode)
    a = _rand(pctx.primes[:dim], (3, dim, 1 << logn), seed=logn)     # 6 slabs
    a[0, :, :3] = np.array(pctx.primes[:dim], dtype=np.uint64)[:, None] - np.uint64(1)
    got = schedule_model(a.reshape(-1, 1 << logn).astype(object), tw, primes, sc,
                                  mode, Arith64, **over)
    want = torch_to_u64(_twin(u64_to_torch(a), ring.ba(dim), mode))
    assert np.array_equal(got.astype(np.uint64).reshape(a.shape), want)


def test_two_pass_model_holds_the_lazy_bounds_at_4p():
    """Forward inputs up to 4p - 1 with p just below 2^61 (the kernel's
    limit): every butterfly of every register group stays below 4p (asserted
    inside Arith64) and the result is right mod p."""
    logn, n = 9, 1 << 9
    p = (1 << 61) - 2 * n + 1
    while not pow(2, p - 1, p) == 1 or not pow(3, p - 1, p) == 1 or not pow(7, p - 1, p) == 1:
        p -= 2 * n
    g = next(g for g in range(2, 100) if pow(g, (p - 1) // 2, p) == p - 1)
    psi = pow(g, (p - 1) // (2 * n), p)
    brv = [int(format(i, f"0{logn}b")[::-1], 2) for i in range(n)]
    z = np.array([pow(psi, brv[i], p) for i in range(n)], dtype=object)
    tw = np.stack([z, (z << 64) // p], -1)[None]
    rng = np.random.default_rng(61)
    a = np.array([[int(v) % (4 * p) for v in rng.integers(0, 1 << 63, n)],
                  [4 * p - 1] * n], dtype=object)
    got = schedule_model(a, tw, np.array([p], dtype=object), None, "fwd", Arith64)
    x = [list(row) for row in a]                      # plain Cooley-Tukey mod p
    for row in x:
        length, k = n // 2, 1
        while length:
            for s in range(0, n, 2 * length):
                for i in range(s, s + length):
                    t = row[i + length] * int(z[k]) % p
                    row[i], row[i + length] = (row[i] + t) % p, (row[i] - t) % p
                k += 1
            length //= 2
    assert np.array_equal(got, np.array(x, dtype=object))


def test_index_maps():
    """Every thread's 8 registers tile the sequence at every window; the
    kernel's twiddle index is the table's n/(2 len) + block index; the
    geometry covers every sequence once."""
    for L in range(ntt_cuda.PASS_LOG_MIN, ntt_cuda.PASS_LOG_MAX + 1):
        m, t = 1 << L, np.arange(1 << (L - 3))
        assert sum(ntt_cuda.stage_groups(L)) == L
        los = [lo for lo, _, _ in ntt_cuda.group_windows(L)]
        assert los[-1] == 0 and ntt_cuda.group_windows(L)[-1][2] == 0
        for lo, w, a in ntt_cuda.group_windows(L):
            idx = np.stack([ntt_cuda.element_index(t, e, a) for e in range(8)], 1)
            assert sorted(idx.ravel()) == list(range(m))
            for b in range(lo - a, lo - a + w):
                for e0 in (e for e in range(8) if not e >> b & 1):
                    zi = ntt_cuda.twiddle_index(5, L, a, b, t, e0)
                    assert np.array_equal(zi, (5 << (L - 1 - a - b)) + (idx[:, e0] >> (a + b + 1)))
                    assert np.array_equal(idx[:, e0 | 1 << b], idx[:, e0] + (1 << (a + b)))
    for logn in range(4, 17):
        for word in (64, 32):
            for nslab in (1, 3, 130):
                logn1, logn2 = ntt_cuda.split_logn(logn)
                assert logn1 + logn2 == logn and max(logn1, logn2) <= ntt_cuda.PASS_LOG_MAX
                for g in pass_geometry(logn, nslab, word):
                    assert ntt_cuda.PASS_LOG_MIN <= g["L"] <= ntt_cuda.PASS_LOG_MAX
                    assert g["threads"] == g["seqs"] << (g["L"] - 3) <= 1024
                    assert g["smem_words"] * word // 8 <= 48 * 1024
                    nseq = nslab << (logn - g["L"])
                    assert (g["blocks"] - 1) * g["seqs"] < nseq <= g["blocks"] * g["seqs"]
                    assert g["blocks"] <= 64 * nslab        # what _MAX_SLABS assumes


def test_plan_rejects_bad_tables(rings):
    _, _, ring = rings
    tables = ntt_cuda.make_kernel_tables(ring.pctx, torch.device("cpu"))
    good = ntt_cuda.make_plan(ring.pctx, DIM, ring.ba(DIM), tables)
    flat = ntt_cuda.KernelTables(64, tables.primes, tables.tw_f[..., 0], tables.tw_i[..., 0])
    with pytest.raises(ValueError, match="interleaved"):
        ntt_cuda.NttPlan(DIM, N, None, flat, good.scale, good.scale_phat)
    strided = ntt_cuda.KernelTables(64, tables.primes, tables.tw_f.transpose(1, 2).contiguous()
                                    .transpose(1, 2), tables.tw_i)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.NttPlan(DIM, N, None, strided, good.scale, good.scale_phat)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.NttPlan(DIM, N, None, tables, good.scale.T.contiguous().T, good.scale_phat)
    with pytest.raises(ValueError, match="int64"):
        ntt_cuda.NttPlan(DIM, N, None, tables, good.scale.to(torch.int32), good.scale_phat)
