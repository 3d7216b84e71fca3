"""The four-step NTT (ops/ntt4.py) against the JAX package's, and K8's
fused stage (csrc/ntt4.cu) through its numpy model.

  - make_ntt4_plan equals JAX's make_ntt4_plan table for table (the digit
    planes in the GEMM's layout: JAX's first P planes, its others zero);
    the kernel's byte planes recompose W exactly, its fold constants are
    2^(32 q) R mod p;
  - ntt4, intt4 and intt4(scale_phatinv=True) bit-equal to JAX's ntt4,
    intt4 and RingEngine(ntt_impl="matmul").ntt_i(..., scale_phatinv=True),
    at logn 4-12, odd and even (n1 != n2), on the 59-bit chain, logp=29 and
    tests/test_crt_mode.py's logp=9 chain, with leading batch axes and rows
    of the edge words 0 and p - 1; the round trip;
  - the plain combine at its largest digit sums for 1-4 planes against
    Python integers;
  - the wrapper of ops/ntt4_cuda.py with the model of the kernel
    (tests/torch_ntt4_model.py) in place of the library: every stage equal
    to the plain stage (split, torch.bmm, combine), every output word
    written once, on chip_smoke.py's K8 edge cases (the card runs the same
    ones, to logn=16), on the three chains at their larger rings, and at a
    stage's largest anti-diagonal sums for 2, 4 and 8 byte planes; the
    fragment maps; the wrapper's argument checks; the model's constants
    against ntt4.cu's.
JAX runs under jax.jit.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import ntt4 as jntt4
from gpqhe_tpu.ring.poly import RingEngine as JRingEngine

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import cuda_build, ntt4_cuda
from gpqhe_tpu_torch.ops import ntt4 as tntt4
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch

import torch_ntt4_model as nm
from chip_smoke import CRT_CHAIN, MODES, ntt4_edge_cases, ntt4_input, ntt4_max_sums

torch.set_num_threads(1)

DIM = 3
# (logp, logn): every parity of logn on the 59-bit chain, both on logp=29,
# the logp=9 chain at its ring
RINGS = [(59, 4), (59, 5), (59, 8), (59, 11), (59, 12), (29, 6), (29, 7), (29, 12), (9, 4)]


def _ctx(pkg_ctx, logp, logn):
    if logp == 9:
        return pkg_ctx(logn, **CRT_CHAIN)
    return pkg_ctx(logn, q=1 << 20, logp=logp, dim_cap=8)


_CACHE = {}


def _rings(logp, logn):
    key = (logp, logn)
    if key not in _CACHE:
        jp, tp = _ctx(JPolyContext, logp, logn), _ctx(PolyContext, logp, logn)
        _CACHE[key] = (jp, tp, jntt4.make_ntt4_plan(jp, DIM), tntt4.make_ntt4_plan(tp, DIM))
    return _CACHE[key]


def _inputs(tp, logn, seed):
    """[2, 2, DIM, n] residues: random, then a row of 0 and a row of p - 1."""
    ps = np.array(tp.primes[:DIM], dtype=np.uint64)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 62, size=(2, 2, DIM, 1 << logn), dtype=np.uint64) % ps[:, None]
    x[0, 1] = 0
    x[1, 0] = ps[:, None] - np.uint64(1)
    return x


@pytest.mark.parametrize("logp,logn", RINGS)
def test_plan_equals_jax(logp, logn):
    _, _, jp, tp = _rings(logp, logn)
    assert (tp.n1, tp.n2, tp.dim) == (jp.n1, jp.n2, jp.dim)
    assert tp.planes == {59: 4, 29: 2, 9: 1}[logp]
    assert tp.planes8 == {59: 8, 29: 4, 9: 2}[logp]
    for k in ("ps", "pinv", "twid", "twist", "twid_i", "twist_i", "c_pow"):
        a, b = np.asarray(getattr(jp, k)), torch_to_u64(getattr(tp, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    for k in ("w1dig", "w2dig", "w1dig_i", "w2dig_i"):
        a = np.asarray(getattr(jp, k))
        m = a.shape[-1]
        b = getattr(tp, k).numpy().reshape(DIM, tp.planes, m, m)
        assert np.array_equal(a[:, :tp.planes], b) and not a[:, tp.planes:].any(), k
    ps = [int(p) for p in np.asarray(jp.ps)]
    R = 1 << 64
    want = [[(1 << 32 * q) * R % p for q in range(4)] for p in ps]
    assert torch_to_u64(tp.c32).tolist() == want


@pytest.mark.parametrize("logp,logn", RINGS)
def test_byte_planes_recompose_w(logp, logn):
    """The kernel's P8 byte planes of each W, sum_v plane_v 2^(8 v), are W
    word for word (the 16-bit planes' sum), and every byte is a byte."""
    _, _, _, tp = _rings(logp, logn)
    for name in ("w1", "w2", "w1_i", "w2_i"):
        u8 = tp.w(name, "u8").numpy()
        dig = tp.w(name, "dig").numpy()
        m = u8.shape[-1]
        assert u8.dtype == np.uint8 and u8.shape == (DIM, tp.planes8, m, m)
        words = sum(u8[:, v].astype(np.uint64) << np.uint64(8 * v) for v in range(tp.planes8))
        d16 = dig.reshape(DIM, tp.planes, m, m).astype(np.uint64)
        want = sum(d16[:, v] << np.uint64(16 * v) for v in range(tp.planes))
        assert np.array_equal(words, want), name
        ps = np.array(tp.ps.numpy(), dtype=np.uint64)[:, None, None]
        assert (words < ps).all(), name


@pytest.mark.parametrize("logp,logn", RINGS)
def test_transforms_bit_equal_to_jax(logp, logn):
    jctx, tctx, jp, tp = _rings(logp, logn)
    x = _inputs(tctx, logn, seed=logn + logp)
    xt = u64_to_torch(x)
    jring = JRingEngine(jctx, ntt_impl="matmul")
    jring.prepare(DIM)
    want = {"fwd": jax.jit(lambda a: jntt4.ntt4(a, jp))(jnp.asarray(x)),
            "inv": jax.jit(lambda a: jntt4.intt4(a, jp))(jnp.asarray(x)),
            "inv_scaled": jax.jit(lambda a: jring.ntt_i(a, DIM, scale_phatinv=True))(
                jnp.asarray(x))}
    got = {"fwd": tntt4.ntt4(xt, tp), "inv": tntt4.intt4(xt, tp),
           "inv_scaled": tntt4.intt4(xt, tp, scale_phatinv=True)}
    for mode in want:
        assert np.array_equal(np.asarray(want[mode]), torch_to_u64(got[mode])), mode
    assert torch.equal(tntt4.intt4(got["fwd"], tp), xt)
    assert torch.equal(tntt4.ntt4(got["inv"], tp), xt)


@pytest.fixture
def model_lib(monkeypatch):
    """ops/ntt4_cuda.py's wrappers with the model in place of the library:
    CPU tensors pass the device check, the model reads their memory."""
    lib = nm.ModelLib()
    monkeypatch.setattr(ntt4_cuda, "_lib", lib)
    monkeypatch.setattr(cuda_build, "check_device", lambda *a: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda dev: 0)
    return lib


def _both(record):
    """A stage that runs the wrapper (the model) and the plain version on the
    same inputs, records whether they agree, and hands on the wrapper's
    output."""
    def stage(*a):
        k, p = ntt4_cuda.stage(*a), tntt4.plain_ntt4_stage(*a)
        record.append(("stage", torch.equal(k, p)))
        return k
    return stage


@pytest.mark.parametrize("case", ntt4_edge_cases(max_logn=10), ids=lambda c: c["id"])
def test_kernel_steps_equal_plain_at_the_edges(model_lib, case):
    pctx = PolyContext(case["logn"], **case["ctx"])
    plan = tntt4.make_ntt4_plan(pctx, case["dim"])
    x = ntt4_input(case, plan, "cpu")
    record = []
    inverse = case["mode"] != "fwd"
    scale = plan.phatinv if case["mode"] == "inv_scaled" else None
    got = tntt4.transform(x, plan, inverse, scale, _both(record))
    want = (tntt4.plain_ntt4(x, plan) if not inverse
            else tntt4.plain_intt4(x, plan, scale is not None))
    assert [r[0] for r in record] == ["stage"] * 2 and all(r[1] for r in record)
    assert torch.equal(got, want)
    assert len(model_lib.plans) == 2


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_combine_at_the_largest_digit_sums(P):
    """The plain combine with every product entry at 256 (2^16 - 1)^2 (k =
    256): the anti-diagonal sums and their carries at their largest fit its
    limbs, and the result equals Python integers' (value mod p, then the
    untwist table and phat^-1 in Montgomery form)."""
    tp = dataclasses.replace(_rings(59, 8)[3], planes=P)
    m, j, B = tp.n1, tp.n2, 2
    top = 256 * 65535 ** 2
    y = torch.full((DIM, P * m, B * P * j), float(top), dtype=torch.float64)
    got = torch_to_u64(tntt4.plain_ntt4_combine(y, tp, (B,), m, j, tp.twist_i, tp.phatinv))
    value = sum(min(w + 1, 2 * P - 1 - w) * top << 16 * w for w in range(2 * P - 1))
    ps, tab = torch_to_u64(tp.ps), torch_to_u64(tp.twist_i).reshape(DIM, m * j)
    ph = torch_to_u64(tp.phatinv)
    rinv = [pow(1 << 64, -1, int(p)) for p in ps]
    for d in range(DIM):
        p = int(ps[d])
        want = [value % p * int(t) * rinv[d] % p * int(ph[d]) * rinv[d] % p for t in tab[d]]
        assert got[:, d].tolist() == [want] * B


@pytest.mark.parametrize("P8", [2, 4, 8])
def test_stage_at_the_largest_digit_sums(model_lib, P8):
    """A stage with K = 256 and every byte of W and X at 255: the model's
    s32 anti-diagonal sums reach their bound P8 K 255^2 (< 2^31, asserted
    there), its groups of four stay below 2^52, and the result equals the
    plain stage's."""
    _, _, _, tp = _rings(59, 8)
    args = ntt4_max_sums(tp, P8, "cpu")
    assert torch.equal(ntt4_cuda.stage(*args), tntt4.plain_ntt4_stage(*args))
    assert model_lib.max_sum == nm.max_diagonal_sum(P8, 256) < 2 ** 31
    assert model_lib.plans[-1][3] == 256 and model_lib.plans[-1][5] == P8
    assert model_lib.plans[-1][10] == (64 if P8 == 8 else 128)


def test_tile_rows_at_the_paths_shapes():
    """The rows a block takes (ntt4.cu's tile_rows, mirrored by the model)
    at the main path's logn=14 shapes on an H100's 132 SMs: the widest tile
    where the grid keeps every SM at two blocks, halved for small batches."""
    src = open(ntt4_cuda.SOURCE).read()
    assert "(tm / 2 >= K || (long long)((K + tm - 1) / tm) * tiles_j * slabs < 2LL * sms)" in src
    got = {(P8, slabs): nm.tile_rows(P8, 128, 128, slabs, 132)
           for P8, slabs in ((8, 64), (8, 48), (8, 24), (8, 8), (4, 124), (4, 93), (4, 47),
                             (4, 16))}
    assert got == {(8, 64): 64, (8, 48): 64, (8, 24): 32, (8, 8): 32, (4, 124): 128,
                   (4, 93): 128, (4, 47): 64, (4, 16): 32}
    assert nm.tile_rows(8, 16, 16, 1, 1) == 32 and nm.tile_rows(2, 256, 32, 6, 1) == 128


@pytest.mark.parametrize("logp,logn", [(59, 12), (29, 12), (9, 4)])
@pytest.mark.parametrize("mode", MODES)
def test_model_transforms_equal_plain_on_each_chain(model_lib, logp, logn, mode):
    """The kernel's transforms (the model in the library's place) bit-equal
    to plain_ntt4 / plain_intt4 on the 59-bit, logp=29 and logp=9 chains
    (8, 4 and 2 byte planes), with leading batch axes and edge words."""
    _, tctx, _, tp = _rings(logp, logn)
    xt = u64_to_torch(_inputs(tctx, logn, seed=7 + logn + logp))
    if mode == "fwd":
        got, want = tntt4.kernel_ntt4(xt, tp), tntt4.plain_ntt4(xt, tp)
    else:
        scaled = mode == "inv_scaled"
        got, want = tntt4.kernel_intt4(xt, tp, scaled), tntt4.plain_intt4(xt, tp, scaled)
    assert torch.equal(got, want)
    assert [p[5] for p in model_lib.plans] == [tp.planes8] * 2


def test_fragment_maps_cover_each_element_once():
    """The m16n8k32 maps of the model: A's 32 lanes x 4 registers x 4 bytes
    are its 16 x 32 bytes once each, B's 32 x 2 x 4 its 32 x 8, D's 32 x 4
    its 16 x 8; and ldmatrix.x4 of a row-major [16 rows x 32 bytes] tile
    from the kernel's lane addresses gives each lane its A fragment."""
    for rows, cols, shape in ((nm.A_ROW, nm.A_COL, (16, 32)), (nm.B_ROW, nm.B_COL, (32, 8)),
                              (nm.D_ROW, nm.D_COL, (16, 8))):
        flat = np.ravel_multi_index((rows.ravel(), cols.ravel()), shape)
        assert np.array_equal(np.sort(flat), np.arange(shape[0] * shape[1]))
    KS = 48
    tile = np.random.default_rng(0).integers(0, 256, size=(16, KS), dtype=np.uint8)
    lane = np.arange(32)
    addr = ((lane & 7) + 8 * ((lane >> 3) & 1)) * KS + 16 * (lane >> 4)
    a = nm.ldmatrix_x4(tile.reshape(1, -1), addr)[0]
    assert np.array_equal(a, tile[nm.A_ROW, nm.A_COL])
    # B: X's planes are [columns][k], two planes of 8 columns one after the
    # other; registers 2 u, 2 u + 1 of the x4 are plane u's fragment, k
    # halves by register
    addr = ((lane >> 4) * 8 + (lane & 7)) * KS + 16 * ((lane >> 3) & 1)
    bf = nm.ldmatrix_x4(tile.reshape(1, -1), addr)[0]
    for u in range(2):
        b = bf[:, 2 * u:2 * u + 2]
        assert np.array_equal(b, tile[8 * u + nm.B_COL, nm.B_ROW])


@pytest.mark.parametrize("sms", [1, 132])
def test_kernel_transform_equals_plain(model_lib, sms):
    """Both directions through the model, at the widest tiles (every SM
    busy: sms=1) and at the small grid's narrowest (an H100's 132 SMs)."""
    model_lib.sms = sms
    _, tctx, _, tp = _rings(59, 11)
    xt = u64_to_torch(_inputs(tctx, 11, seed=3))
    assert torch.equal(tntt4.kernel_ntt4(xt, tp), tntt4.plain_ntt4(xt, tp))
    assert torch.equal(tntt4.kernel_intt4(xt, tp, True), tntt4.plain_intt4(xt, tp, True))
    assert [p[10] for p in model_lib.plans] == ([32, 64, 64, 32] if sms == 1 else [32] * 4)
    steps = [p[6:10] for p in model_lib.plans]
    # (transpose, pre, post, scale): forward: the pre-twist and twiddle
    # stage, then the transposing bare stage
    assert steps[:2] == [(False, True, True, False), (True, False, False, False)]
    # inverse: the bare stage, then the transposing twiddle, untwist and scale
    assert steps[2:] == [(False, False, False, False), (True, True, True, True)]
    # (K, J) at n1 = 32, n2 = 64: W1 over the columns, then W2 over the rows
    assert [p[3:5] for p in model_lib.plans] == [(32, 64), (64, 32), (64, 32), (32, 64)]


def test_wrapper_checks(model_lib):
    _, tctx, _, tp = _rings(59, 8)
    x = u64_to_torch(_inputs(tctx, 8, seed=5))
    with pytest.raises(ValueError, match="a stage takes"):
        ntt4_cuda.stage(x[..., :128], tp, "w1", 16, 16, False, None, None, None)
    with pytest.raises(ValueError, match="contiguous table"):
        ntt4_cuda.stage(x, tp, "w1", 16, 16, False, tp.twist[:, ::2], None, None)
    with pytest.raises(ValueError, match="contiguous table"):
        ntt4_cuda.stage(x, tp, "w1", 16, 16, False, None, tp.twid[:, :8], None)
    with pytest.raises(ValueError, match="int64"):
        ntt4_cuda.stage(x.to(torch.int32), tp, "w1", 16, 16, False, None, None, None)
    out = ntt4_cuda.stage(x, tp, "w1", 16, 16, False, None, None, None)
    assert out.shape == x.shape
    with pytest.raises(ValueError, match="byte planes"):
        ntt4_cuda.stage(x, dataclasses.replace(tp, w1u8=tp.w1u8.to(torch.int16)), "w1", 16, 16,
                        False, None, None, None)
    _, _, _, tp4 = _rings(59, 4)
    big = torch.zeros((22000, DIM, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="slabs"):
        ntt4_cuda.stage(big, tp4, "w1", 4, 4, False, None, None, None)
    _, tctx12, _, _ = _rings(59, 12)
    wide = tntt4.make_ntt4_plan(tctx12, 1)
    with pytest.raises(ValueError, match="contraction of 512"):
        ntt4_cuda.stage(torch.zeros((1, 1, 1 << 12), dtype=torch.int64), wide, "w2", 8, 512,
                        True, None, None, None)


def test_cpu_tensors_never_reach_the_kernels():
    """Without the model the wrappers refuse a CPU tensor; ntt4/intt4 take
    the plain versions for it."""
    _, tctx, _, tp = _rings(59, 5)
    x = u64_to_torch(_inputs(tctx, 5, seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        ntt4_cuda.stage(x, tp, "w1", 4, 8, False, tp.twist, tp.twid, None)
    before = dict(ntt4_cuda.LAUNCHES)
    tntt4.ntt4(x, tp)
    assert ntt4_cuda.LAUNCHES == before


def test_model_constants_match_the_source():
    src = open(ntt4_cuda.SOURCE).read()
    defs = dict(re.findall(r"^#define (\w+) (\d+)", src, flags=re.M))
    for name in ("THREADS", "TILE_M8", "TILE_M4", "TILE_M_MIN", "TILE_J", "WARP_M", "WARP_J",
                 "PAD", "MAX_K", "LOAD_ITEMS"):
        assert int(defs["NTT4_" + name]) == getattr(nm, name), name
    assert nm.MAX_K == ntt4_cuda.MAX_K and 1 << (tntt4.LOGN_MAX // 2) == nm.MAX_K
    assert "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in src
    assert "NG = (2 * P8 + 2) / 4" in src
    assert "PW = P8 == 8 ? 8 : NW" in src
    assert [nm.pass_width(P8) for P8 in (2, 4, 8)] == [3, 7, 8]
    assert [nm.folds_of(P8) for P8 in (2, 4, 8)] == [1, 2, 4]
    assert all(f"ntt4_stage_kernel<{P8}, {t}>" in src for P8 in (2, 4, 8)
               for t in ("true", "false"))
    assert ntt4_cuda.GRID_Y == nm.GRID_Y
