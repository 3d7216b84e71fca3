"""K4 decompose and K6's digit product (csrc/rns.cu) without a card: the
numpy model of each kernel (tests/torch_rns_model.py) against Python
integers and the plain torch versions.

  - decompose's arithmetic on its IMAD route (the limb constants made from
    the weights, the 32 x 64-bit products summed in four 32-bit words by the
    PTX carry chain, one Montgomery reduction a group of 256 limbs, the
    signed form) and on its tensor-core route (the rows' bytes against the
    u8 table of 2^(8 j) R mod p, the s32 byte-column sums and their bound,
    the fold into V with hi < p, one Montgomery reduction, the signed form)
    on edge rows: all 0xFFFFFFFF, 0, the multiples of p and their
    neighbours, two's-complement values at every src_bits edge, on the
    59-bit, logp=29 and logp=9 primes; the route by K (MMA_MIN_LIMBS);
  - the digit product's arithmetic (the residues' byte planes against the
    plan's u8 table, the s32 byte-column sums and their bound, the combine
    into 16-bit digit sums): the digit sums equal plain_digit_partials'
    value mod 2^(16 kd), and lifted by plain_lift the plain reconstruct,
    on both widths of residue, fast and exact, scaled and pre-scaled, at
    1-128 primes, rows and depth off the tiles' edges, and on a mesh
    shard's table;
  - both launches' work split (blocks, tiles of primes or byte columns,
    lanes and warps, staged chunks, the slab loop): every output word
    written once, through ops/rns_cuda.py's wrappers as they call the
    library, on tests/torch_cases.py's edge cases (the card runs the same
    ones);
  - the model's constants against rns.cu's #defines.
The file compiles no JAX program.
"""

import re

import numpy as np
import pytest
import torch

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import cuda_build, rns_cuda
from gpqhe_tpu_torch.ops import rns as tr
from gpqhe_tpu_torch.substrate import bigint

import torch_rns_model as rm
import torch_rowwarp_model as rt
from torch_cases import CRT_CHAIN, ew_compare, rns_edge_cases

torch.set_num_threads(1)

U = np.uint64
CHAINS = {59: PolyContext(6, q=1 << 20, dim_cap=24),
          29: PolyContext(6, q=1 << 20, logp=29, dim_cap=24),
          9: PolyContext(4, **CRT_CHAIN)}


def _edge_rows(K, primes, src_bits):
    """Python ints of K limbs: all ones, 0, k p - 1, k p, k p + 1 for the
    first prime and multiples up to the top of the row, and (src_bits) the
    two's-complement edges -1, -2^(src-1), 2^(src-1) - 1, 1 with any bits
    above src_bits set or clear."""
    top = 1 << (32 * K)
    vals = [top - 1, 0, 1]
    for p in primes[:2]:
        for k in (1, 2, 3, (top - 1) // p, (top - 1) // p - 1, 1 << 17):
            vals += [v for v in (k * p - 1, k * p, k * p + 1) if 0 <= v < top]
    if src_bits:
        s = src_bits
        low = [(1 << s) - 1, 1 << (s - 1), (1 << (s - 1)) - 1, 1, (1 << s) - 2]
        vals += low + [v | (top - (1 << s)) for v in low]
    return vals


@pytest.mark.parametrize("logp", [59, 29, 9])
@pytest.mark.parametrize("K", [1, 2, 3, 14, 28, 65, 300])
def test_decompose_arithmetic_on_edge_rows(logp, K):
    """The model of the kernel's sums and reduction equals v mod p, and the
    signed form (v mod 2^src) - 2^src mod p for a row whose bit src - 1 is
    set, at src_bits 1, 31, 32, 33, 32 K - 5 and 32 K."""
    pctx = CHAINS[logp]
    dim = min(6, len(pctx.primes))
    p = np.asarray(pctx.primes[:dim], dtype=U)
    pinv = np.asarray(pctx.basis(dim).pinv_mont, dtype=U)
    w = tr.make_decomp_weights(pctx, dim, K)
    for src in sorted(b for b in {0, 1, 31, 32, 33, 32 * K - 5, 32 * K} if b <= 32 * K):
        vals = _edge_rows(K, pctx.primes, src)
        x = np.stack([bigint.int_to_limbs(v, K) for v in vals]).astype(U)
        got, nh = rm.decompose_rows(x, w, p, pinv, src)
        assert nh == {59: 2, 29: 1, 9: 1}[logp]
        if src:
            vals = [(v % (1 << src)) - (1 << src) if (v >> (src - 1)) & 1 else v for v in vals]
        want = np.array([[v % q for v in vals] for q in pctx.primes[:dim]], dtype=object)
        assert np.array_equal(got.astype(object), want), (src, logp, K)


@pytest.mark.parametrize("logp", [59, 29, 9])
@pytest.mark.parametrize("K", [1, 2, 3, 14, 19, 20, 28, 33, 55, 57, 65, 130])
def test_decompose_mma_arithmetic_on_edge_rows(logp, K):
    """The model of the tensor-core route (the rows' bytes against
    decomp_byte_table, s32 column sums, the fold, hi < p, one Montgomery
    reduction) equals v mod p, and the signed form (v mod 2^src) - 2^src mod
    p for a row whose bit src - 1 is set, at src_bits 1, 31, 32, 33, 32 K -
    5 and 32 K; its table takes 8 bytes a constant on the 59-bit chain and
    4 on the others."""
    pctx = CHAINS[logp]
    dim = min(6, len(pctx.primes))
    p = np.asarray(pctx.primes[:dim], dtype=U)
    pinv = np.asarray(pctx.basis(dim).pinv_mont, dtype=U)
    w = tr.make_decomp_weights(pctx, dim, K)
    table = rns_cuda.decomp_byte_table(pctx.primes[:dim], 2 * w.shape[1])
    nb = rns_cuda.const_bytes(max(pctx.primes[:dim]))
    assert nb == {59: 8, 29: 4, 9: 4}[logp] and table.shape[0] == nb * dim
    for src in sorted(b for b in {0, 1, 31, 32, 33, 32 * K - 5, 32 * K} if b <= 32 * K):
        vals = _edge_rows(K, pctx.primes, src)
        x = np.stack([bigint.int_to_limbs(v, K) for v in vals]).astype(U)
        got, maxcol = rm.decompose_mma_rows(x, table, nb, w, p, pinv, src)
        assert maxcol <= 4 * K * 255**2
        if src:
            vals = [(v % (1 << src)) - (1 << src) if (v >> (src - 1)) & 1 else v for v in vals]
        want = np.array([[v % q for v in vals] for q in pctx.primes[:dim]], dtype=object)
        assert np.array_equal(got.astype(object), want), (src, logp, K)


def test_decomp_byte_table_holds_the_bytes_of_the_constants():
    """Row nb d + k, column j of the table is byte k of 2^(8 j + 64) mod p_d,
    zero past the 4 K bytes of depth and rounded up to a chunk; the rows'
    bytes against it sum, column by column and folded, to sum_j x_j 2^(8 j)
    R mod p (Python integers), the fold's high word below p."""
    rng = np.random.default_rng(6)
    for logp, K in ((59, 55), (29, 28), (9, 3)):
        primes = CHAINS[logp].primes[:5]
        t = rns_cuda.decomp_byte_table(primes, K)
        nb = rns_cuda.const_bytes(max(primes))
        assert t.shape == (nb * len(primes), -(-4 * K // rns_cuda.DEPTH) * rns_cuda.DEPTH)
        assert not t[:, 4 * K:].any()
        for d, p in enumerate(primes):
            for j in (0, 1, 4 * K - 1):
                c = sum(int(t[nb * d + k, j]) << (8 * k) for k in range(nb))
                assert c == pow(2, 8 * j + 64, p)
        x = rng.integers(0, 1 << 32, size=(3, K), dtype=U)
        cols = rm.column_sums(rm.limb_bytes(x), t, nb * len(primes)).reshape(3, -1, nb)
        hi, lo = rm.fold(cols, nb)
        for r in range(3):
            v = sum(int(x[r, i]) << (32 * i) for i in range(K))
            for d, p in enumerate(primes):
                V = (int(hi[r, d]) << 64) | int(lo[r, d])
                assert V == sum(int(s) << (8 * k) for k, s in enumerate(cols[r, d]))
                assert V % p == (v << 64) % p and int(hi[r, d]) < p


def test_decompose_mma_sums_and_fold_stay_in_their_words():
    """The bounds the tensor-core route rests on, at their extremes: a byte
    column sums at most 4 K 255^2, below 2^31 for K <= 8256 (the mma's s32);
    at K = 130 every byte 255 against every table byte 255 reaches it; the
    fold of such sums is V < 4 K 2^8 p, whose high word stays below the
    smallest prime of the three chains."""
    assert 4 * 8256 * 255**2 < 2**31 <= 4 * 8257 * 255**2
    K = 130
    a = np.full((2, 4 * K), 255, dtype=np.uint8)
    cols = rm.column_sums(a, np.full((8, 4 * K), 255, dtype=np.uint8), 8)
    assert (cols == 4 * K * 255**2).all()
    hi, lo = rm.fold(cols[:, None, :], 8)
    assert (int(hi[0, 0]) << 64 | int(lo[0, 0])) == 4 * K * 255**2 * (2**64 - 1) // 255
    for p in (CHAINS[9].primes[0], CHAINS[29].primes[0], CHAINS[59].primes[0]):
        assert (4 * K * 256 * p) >> 64 < p
    with pytest.raises(AssertionError, match="s32"):
        rm.column_sums(np.full((1, 4 * 8257), 255, dtype=np.uint8),
                       np.full((1, 4 * 8257), 255, dtype=np.uint8), 1)


def test_decompose_sums_stay_in_their_words():
    """The bounds the kernel's reduction rests on, at their extremes: a
    group of 256 limbs of 0xFFFFFFFF against constants of p - 1 sums below
    2^128 (one half: below 2^96), and its high 64-bit word stays below p,
    for the smallest and the largest primes of the three chains."""
    for p in (CHAINS[9].primes[0], CHAINS[29].primes[-1], CHAINS[59].primes[0],
              CHAINS[59].primes[-1]):
        top = rm.DEC_GROUP * (2**32 - 1) * (p - 1)
        assert top < 2**(64 * rm.halves_of(p) + 32) and top >> 64 < p


def _defines(path):
    return {m[0]: int(m[1]) for m in
            re.findall(r"^#define (\w+) (\d+)", open(path).read(), flags=re.M)}


def test_rns_constants_mirror_the_source():
    d = _defines(rns_cuda.SOURCE)
    for name in ("DEC_WARPS", "DEC_ROWS", "DEC_PRIMES", "DEC_KC", "DEC_GROUP", "DS_WARPS",
                 "DS_WARP_M", "DS_WARP_N", "DS_DEPTH", "DS_PAD", "DS_BLOCKS_AN_SM",
                 "DS_OUT_PAD", "DM_ROWS", "DM_OUT_PAD"):
        assert d[name] == getattr(rm, name), name
    assert rns_cuda.DEPTH == rm.DS_DEPTH
    # a warp takes two primes of a tile and a lane two rows, 32 apart
    assert rm.DEC_PRIMES == 2 * rm.DEC_WARPS and rm.DEC_ROWS == 64
    assert rm.DEC_GROUP % rm.DEC_KC == 0
    # the digit product: a block's bm x bn tile, 256 / wn rows against 64 wn
    # byte columns, and a row of a chunk 16 bytes past its 128 (ldmatrix's
    # rows an odd number of 16-byte units apart)
    assert [rm.launch_shape(kd)[1:] for kd in (32, 64, 128)] == [(256, 64), (128, 128),
                                                                 (64, 256)]
    assert ((rm.DS_DEPTH + rm.DS_PAD) // 16) % 2 == 1
    # the tensor-core decompose: 64 rows (two warps of 32 down) against 256
    # byte columns (four of 64 across), a chunk of depth 32 limbs
    assert (rm.DM_ROWS, rm.DM_COLS, rm.DM_CHUNK) == (64, 256, 32)


def test_fastdiv_splits_the_staged_chunks():
    """The staging loops split a flat index by the chunk's limbs (1-64) with
    rowwarp.cuh's FastDiv: exact over a block's rows (and the tile's primes)."""
    idx = np.arange(rm.DEC_ROWS * rm.DEC_KC, dtype=U)
    for kc in range(1, rm.DEC_KC + 1):
        d = rt.fastdiv(kc)
        sub = idx[:rm.DEC_ROWS * kc]
        assert np.array_equal(d(sub), sub // U(kc)), kc


@pytest.fixture
def model_lib(monkeypatch):
    """ops/rns_cuda.py's wrappers with the model in place of the library:
    CPU tensors pass the device check, the model reads their memory."""
    lib = rm.ModelLib()
    monkeypatch.setattr(rns_cuda, "_lib", lib)
    monkeypatch.setattr(cuda_build, "check_device", lambda *a: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda dev: 0)
    return lib


def _run(lib, case):
    before = len(lib.plans)
    out = getattr(rns_cuda, case["op"])(*case["args"])
    return out, lib.plans[before:]


@pytest.fixture(scope="module")
def edge_cases():
    rings = {59: PolyContext(10, q=1 << 20, dim_cap=72),
             29: PolyContext(10, q=1 << 20, logp=29, dim_cap=72)}
    return rns_edge_cases(torch.device("cpu"), rings)


def test_decompose_launches_at_the_edges(model_lib, edge_cases):
    """torch_cases.py's decompose edge cases through the wrapper and the
    model of the launch, on the route K takes (K* = MMA_MIN_LIMBS) and on
    each route's own entry: equal to the plain version, every output word
    written once, and every branch of both designs taken (the IMAD kernel:
    one and two 32-bit halves a constant, one and several tiles of primes,
    one and two staged chunks of limbs, a second group of 256 limbs; the
    tensor cores: 8 and 4 bytes a constant, one and two tiles of columns, a
    warp's columns partly live, one and several chunks of depth; both: a
    partial block, signed rows; S = 0 launches nothing)."""
    seen = {"decompose": [], "decompose_mma": []}
    for case in (c for c in edge_cases if c["entry"] == "decompose"):
        want = case["plain"]()
        out, plans = _run(model_lib, case)
        assert torch.equal(out, want), case["shape"]
        assert len(plans) == (1 if out.numel() else 0), case["shape"]
        k = case["args"][0].shape[-1]
        route = "decompose_mma" if rns_cuda.takes_mma(k) else "decompose"
        assert all(p["entry"] == route for p in plans), (case["shape"], route)
        for fn in (rns_cuda.decompose_imad, rns_cuda.decompose_mma):
            before = len(model_lib.plans)
            assert torch.equal(fn(*case["args"]), want), (case["shape"], fn.__name__)
            for p in model_lib.plans[before:]:
                seen[p["entry"]].append(p)
    imad, mma = seen["decompose"], seen["decompose_mma"]
    assert set().union(*(p["nh"] for p in imad)) == {1, 2}
    for key, want in (("tiles", {1, 2, 3}), ("chunks", {1, 2, 5}), ("groups", {1, 2}),
                      ("partial_block", {True}), ("signed", {True, False})):
        assert want <= {p[key] for p in imad}, key
    for key, want in (("nb", {4, 8}), ("col_blocks", {1, 2}), ("chunks", {1, 2, 4, 10}),
                      ("partial_cols", {True, False}), ("partial_block", {True}),
                      ("signed", {True, False})):
        assert want <= {p[key] for p in mma}, key
    assert max(p["max_column"] for p in mma) < 2**31


def test_digit_split_launches_at_the_edges(model_lib, edge_cases):
    """torch_cases.py's digit-product edge cases through the wrapper and the
    model of the launch (rns_cuda.digit_sums): the digit sums equal the
    plain version's as values mod 2^(16 kd), af within a relative 2^-45
    (ew_compare), every digit sum and estimate written once, every byte
    column left to a warp, and every branch of the design taken (one, two
    and four warps across the columns, a second block of columns, residues
    of 4 and 8 bytes, scaled or not, partial blocks of rows and chunks of
    depth, five chunks)."""
    seen = []
    for case in (c for c in edge_cases if c["entry"] == "crt_digit_split"):
        out, plans = _run(model_lib, case)
        eq, err, extra = ew_compare(out, case["plain"]())
        assert eq, (case["shape"], err, extra)
        assert len(plans) == (1 if out[1].numel() else 0), case["shape"]
        seen += plans
    for key, want in (("wn", {1, 2, 4}), ("col_blocks", {1, 2}), ("nb", {4, 8}),
                      ("scaled", {True, False}), ("partial_block", {True, False}),
                      ("partial_depth", {True, False})):
        assert want <= {p[key] for p in seen}, key
    assert max(p["chunks"] for p in seen) >= 5


@pytest.mark.parametrize("K", [3, 70])
def test_slab_loop_past_the_grid(model_lib, K):
    """More slabs than blocks on the grid's slab axis (65535 on the card; 2
    here): a block walks slab after slab, decompose making its constants
    once where a row fits one chunk; the digit product's persistent blocks
    (two an SM; one SM here) walk tile after tile; every word is written
    once."""
    model_lib.grid_z, model_lib.sms = 2, 1
    pctx = CHAINS[59]
    rng = np.random.default_rng(4)
    ba = tr.make_basis_arrays(pctx, 5, "cpu")
    a = torch.from_numpy(rng.integers(0, 1 << 32, size=(5, 70, K), dtype=np.int64))
    w = torch.from_numpy(tr.make_decomp_weights(pctx, 5, K).view(np.int64))
    for src in (None, 32 * K - 3):
        got = rns_cuda.decompose(a, ba.ps, ba.pinv, w, src)
        assert torch.equal(got, tr.decompose_core(a, ba.ps, ba.pinv, w, src))
        assert model_lib.plans[-1]["slab_loop"]
    plan = tr.make_recon_plan(pctx, 5, "cpu")
    y = torch.from_numpy((rng.integers(0, 1 << 62, size=(5, 5, 70), dtype=np.uint64)
                          % np.asarray(pctx.primes[:5], dtype=U)[:, None]).view(np.int64))
    assert ew_compare(rns_cuda.digit_sums(y, plan, plan.ds),
                      tr.plain_digit_partials(y, plan, plan.ds))[0]
    assert model_lib.plans[-1]["slab_loop"]


# ---------------------------------------------------------------------------
# the digit product's arithmetic
# ---------------------------------------------------------------------------

_DIGIT_RINGS = {}


def _digit_ring(logp):
    """A logn=8 ring of 128 primes of the chain's width."""
    if logp not in _DIGIT_RINGS:
        _DIGIT_RINGS[logp] = PolyContext(8, q=1 << 20, logp=logp, dim_cap=128)
    return _DIGIT_RINGS[logp]


def _in_bound_residues(rng, pctx, ba, plan, lead, n, bound):
    """Residues [lead, dim, n] of signed values |v| < 2^bound (half of them
    negative), through the plain decompose."""
    from gpqhe_tpu_torch.ops import limbs as lb
    vals = torch.from_numpy(rng.integers(0, 1 << 32, size=lead + (n, plan.ks)))
    vals = lb.plain_mask_bits(vals, bound - 1)
    vals = lb.plain_select(torch.from_numpy(rng.random(lead + (n,)) < 0.5), lb.plain_neg(vals),
                           vals)
    w = torch.from_numpy(tr.make_decomp_weights(pctx, plan.dim, plan.ks).view(np.int64))
    return tr.decompose(vals, ba, w, src_bits=32 * plan.ks)


def _digit_values(sums, kd):
    """The value sum_j sums_j 2^(16 j) mod 2^(16 kd) of digit sums, as limbs."""
    from gpqhe_tpu_torch.ops import limbs as lb
    return lb.plain_from_digits16(sums.to(torch.int64), kd // 2)


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "pre_scaled"])
@pytest.mark.parametrize("path", ["fast", "exact"])
@pytest.mark.parametrize("dim", [1, 8, 24, 31, 47, 60, 90, 128])
@pytest.mark.parametrize("logp", [59, 29])
def test_digit_product_lifts_to_the_plain_reconstruct(model_lib, logp, dim, path, scaled):
    """The model of rns_cuda.digit_sums (byte planes of the residues against
    the plan's u8 table, s32 byte-column sums, combined into 16-bit digit
    sums) on [2, dim, 333] residues, rows off every block's edge and the
    depth nb dim (8 bytes a residue on the 59-bit chain, 4 on logp=29) on
    and off its chunks' edges: the digit sums equal plain_digit_partials'
    as values mod 2^(16 kd), and plain_lift of them is torch.equal to the
    plain reconstruct: the fast path (kd = 2 k_out) on values within its
    bound, the exact path (kd = ds) on any residues."""
    rng = np.random.default_rng(dim * 7 + logp)
    pctx = _digit_ring(logp)
    plan, ba = tr.make_recon_plan(pctx, dim, "cpu"), tr.make_basis_arrays(pctx, dim, "cpu")
    lead, n = (2,), 333
    if path == "fast":
        bound = plan.logP - 3
        k_out = max(1, min(plan.ks, (bound + 31) // 32))
        c = _in_bound_residues(rng, pctx, ba, plan, lead, n, bound)
        center = True
    else:
        bound = k_out = None
        p = np.asarray(pctx.primes[:dim], dtype=U)[:, None]
        c = torch.from_numpy((rng.integers(0, 1 << 63, size=lead + (dim, n), dtype=U) % p)
                             .view(np.int64))
        center = dim % 2 == 0
    scale = (ba.phatinv_mont, ba.ps, ba.pinv)
    y = c if scaled else tr.plain_mont_mul(c, ba.phatinv_mont[:, None], ba.ps[:, None],
                                           ba.pinv[:, None])
    kd = min(2 * k_out, plan.ds) if k_out else plan.ds
    sums, af = rns_cuda.digit_sums(y, plan, kd, scale if scaled else None)
    assert model_lib.plans[-1]["nb"] == (8 if logp == 59 else 4)
    assert sums.dtype == torch.int64 and sums.shape == lead + (n, kd)
    psd, paf = tr.plain_digit_partials(y, plan, kd, scale if scaled else None)
    assert torch.equal(_digit_values(sums, kd), _digit_values(psd, kd))
    assert ((af - paf).abs() <= 2.0 ** -45 * paf.abs()).all()
    want = tr.reconstruct(y, ba, plan, center=center, k_out=k_out, bound_bits=bound,
                          pre_scaled=not scaled)
    assert torch.equal(tr.plain_lift(sums, af, plan, center, k_out), want)


def test_digit_product_column_sums_stay_in_s32():
    """The bound the kernel's s32 accumulators rest on: a byte-column sum is
    at most nb dim 255^2, below 2^31 for dim <= 4128 at nb = 8; at 128 primes
    the model's extreme (every byte of the residues and of the table 255)
    reaches nb dim 255^2, and the combined digit sums stay below 2^40, inside
    from_digits16's 2^48."""
    assert 8 * 4128 * 255**2 < 2**31 <= 8 * 4129 * 255**2
    a = np.full((3, 8 * 128), 255, dtype=np.uint8)
    t = np.full((16, 8 * 128), 255, dtype=np.uint8)
    cols = rm.column_sums(a, t, 16)
    assert (cols == 8 * 128 * 255**2).all()
    assert rm.combine16(cols).max() < 2**40
    with pytest.raises(AssertionError, match="s32"):
        rm.column_sums(np.full((1, 8 * 4129), 255, dtype=np.uint8),
                       np.full((2, 8 * 4129), 255, dtype=np.uint8), 2)


def test_phat_byte_table_holds_the_bytes_of_phat():
    """Row c, column d nb + t of the table is byte c - t of phat_d: the
    residues' byte planes against it sum to S = sum_d y_d phat_d mod
    2^(16 ds), checked on Python integers (nb = 8 and 4)."""
    rng = np.random.default_rng(5)
    for logp, dim in ((59, 5), (29, 9)):
        pctx = _digit_ring(logp)
        plan = tr.make_recon_plan(pctx, dim, "cpu")
        b = pctx.basis(dim)
        nb = rns_cuda.residue_bytes(plan.nd)
        y = rng.integers(0, 1 << 62, size=(4, dim), dtype=U) % np.asarray(b.primes, dtype=U)
        cols = rm.column_sums(rm.byte_planes(y, nb), plan.phat_bytes.numpy(), 2 * plan.ds)
        for row, c in zip(y, cols):
            got = sum(int(v) << (8 * j) for j, v in enumerate(c))
            want = sum(int(v) * ph for v, ph in zip(row, b.phat))
            assert got % (1 << (16 * plan.ds)) == want % (1 << (16 * plan.ds))


def test_digit_product_on_a_shard_plan(model_lib):
    """A mesh shard's plan (make_recon_plan(rows=...)) holds its rows of the
    whole table, and zeros for rows past the basis: the shards' digit sums
    and estimates, added (reconstruct_sharded's psum), lift to the whole
    basis's exact reconstruct."""
    rng = np.random.default_rng(9)
    pctx = _digit_ring(59)
    dim, n, cut = 10, 200, ((0, 4), (4, 8), (8, 12))
    full, ba = tr.make_recon_plan(pctx, dim, "cpu"), tr.make_basis_arrays(pctx, dim, "cpu")
    nb = rns_cuda.residue_bytes(full.nd)
    p = np.asarray(pctx.primes[:dim], dtype=U)[:, None]
    y = torch.from_numpy((rng.integers(0, 1 << 63, size=(dim, n), dtype=U) % p).view(np.int64))
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:2])])          # noqa: E731
    yp, sc = pad(y), pad(ba.phatinv_mont)
    ps, pv = torch.cat([ba.ps, ba.ps[:2]]), torch.cat([ba.pinv, ba.pinv[:2]])
    total, af = 0, 0
    for r0, r1 in cut:
        shard = tr.make_recon_plan(pctx, dim, "cpu", rows=(r0, r1))
        live = min(r1, dim) - r0
        assert torch.equal(shard.phat_bytes[:, :nb * live],
                           full.phat_bytes[:, nb * r0:nb * (r0 + live)])
        assert not shard.phat_bytes[:, nb * live:].any()
        s, a = rns_cuda.digit_sums(yp[r0:r1], shard, full.ds, (sc[r0:r1], ps[r0:r1], pv[r0:r1]))
        total, af = total + s, af + a
    want = tr.reconstruct(y, ba, full, center=True)
    assert torch.equal(tr.plain_lift(total, af, full, True, None), want)


def test_graphed_cpu_reconstruct_takes_the_plain_digit_product(monkeypatch):
    """A reconstruct on a CPU tensor takes the plain digit product (the
    16-bit split and torch.matmul), never rns_cuda.digit_sums, and a graphed
    program's three calls (the capture and two replays) equal the eager
    reconstruct."""
    from gpqhe_tpu_torch.utils import graphs
    from torch_standin import StandIn
    pctx = _digit_ring(59)
    plan, ba = tr.make_recon_plan(pctx, 6, "cpu"), tr.make_basis_arrays(pctx, 6, "cpu")
    p = np.asarray(pctx.primes[:6], dtype=U)[:, None]
    y = torch.from_numpy((np.random.default_rng(2).integers(0, 1 << 63, size=(6, 64), dtype=U)
                          % p).view(np.int64))
    want = tr.reconstruct(y, ba, plan)

    def refuse(*a, **k):
        raise AssertionError("a CPU reconstruct reached the card's digit product")
    monkeypatch.setattr(rns_cuda, "digit_sums", refuse)
    prog = graphs.Graphs(StandIn()).program(lambda y: tr.reconstruct(y, ba, plan), ("recon",))
    outs = [prog(y) for _ in range(3)]
    assert all(torch.equal(o, want) for o in outs)
