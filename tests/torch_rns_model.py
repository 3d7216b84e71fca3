"""K4 decompose (both routes) and K6's digit product (csrc/rns.cu) in numpy,
for the CPU tests of the kernels: each launch's work split as the kernel
makes it (which block takes which rows or coefficients and which tile of
primes or byte columns, which lane and warp of it which outputs, the slab
loop past 65535 blocks, the staged chunks of 64 limbs, the persistent
blocks' tiles, the chunks of 128 bytes of depth) and its arithmetic as the
kernel runs it (decompose's IMAD route: the limb constants made from the
weights, the 32 x 64-bit products summed in four 32-bit words by the PTX
carry chain, one Montgomery reduction a group of 256 limbs, the signed
form; its tensor-core route: the rows' bytes against the u8 table of
2^(8 j) R mod p, the s32 byte-column sums and their bound, the fold of a
prime's columns into a 128-bit V, hi < p before the one Montgomery
reduction, the signed form; the digit product: the residues' byte planes
against the plan's u8 table, the s32 byte-column sums and their bound, the
combine into 16-bit digit sums, af in the kernel's order), on native u64
words, vectorised over rows.

ModelLib stands in for the built library at its C interface: the wrappers
of ops/rns_cuda.py call it with the same arguments (pointers, strides,
counts) they give the kernel, and it reads and writes the tensors' memory
through those pointers (CPU tensors).  The constants below mirror rns.cu's
#defines (held equal by tests/test_torch_rns_kernel_model.py).
"""

import ctypes
import math

import numpy as np

U = np.uint64
M32 = U(0xFFFFFFFF)
DEC_WARPS = 8             # rns.cu: warps of a decompose block
DEC_ROWS = 64             # rns.cu: rows of a decompose block, two a lane
DEC_PRIMES = 16           # rns.cu: primes of a block's tile, two a warp
DEC_KC = 64               # rns.cu: limbs of a row staged at a time
DEC_GROUP = 256           # rns.cu: limbs summed before a reduction
DS_WARPS = 8              # rns.cu: warps of a digit-product block
DS_WARP_M = 32            # rns.cu: a warp's coefficients (two m16 fragments)
DS_WARP_N = 64            # rns.cu: a warp's byte columns (eight n8 fragments)
DS_DEPTH = 128            # rns.cu: bytes of depth a chunk
DS_PAD = 16               # rns.cu: bytes past a row's chunk in shared memory
DS_BLOCKS_AN_SM = 2       # rns.cu: the digit product's persistent blocks an SM
DS_OUT_PAD = 4            # rns.cu: words past a row of a warp's staged digit sums
SMS = 132                 # the H100's SMs
DS_TILE = DS_WARPS * DS_WARP_M * DS_WARP_N
DM_ROWS = 64               # rns.cu: rows of a tensor-core decompose tile
DM_OUT_PAD = 8             # rns.cu: words past a row of a warp's staged column sums
DM_COLS = DS_TILE // DM_ROWS                 # its byte columns: 256
DM_CHUNK = DS_DEPTH // 4                     # limbs a chunk of depth: 32
GRID_Z = 65535            # the launches' largest grid.y / grid.z


# ---------------------------------------------------------------------------
# mont.cuh on u64 arrays
# ---------------------------------------------------------------------------

def umulhi(a, b):
    a, b = np.asarray(a, dtype=U), np.asarray(b, dtype=U)
    with np.errstate(over="ignore"):
        al, ah, bl, bh = a & M32, a >> U(32), b & M32, b >> U(32)
        ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
        cross = (ll >> U(32)) + (lh & M32) + (hl & M32)
        return hh + (lh >> U(32)) + (hl >> U(32)) + (cross >> U(32))


def mont_reduce(hi, lo, p, pinv):
    """hi:lo R^-1 mod p; the kernel's result is right only for hi < p."""
    hi, lo = np.asarray(hi, dtype=U), np.asarray(lo, dtype=U)
    assert (hi < p).all(), "mont_reduce needs hi < p"
    with np.errstate(over="ignore"):
        t = umulhi(lo * pinv, p)
        return np.where(hi < t, hi - t + p, hi - t)


def mont_mul(a, b, p, pinv):
    a, b = np.asarray(a, dtype=U), np.asarray(b, dtype=U)
    with np.errstate(over="ignore"):
        return mont_reduce(umulhi(a, b), a * b, p, pinv)


def addmod(a, b, p):
    with np.errstate(over="ignore"):
        s = a + b
        return np.where(s >= p, s - p, s)


def submod(a, b, p):
    with np.errstate(over="ignore"):
        return np.where(a < b, a - b + p, a - b)


# ---------------------------------------------------------------------------
# decompose's arithmetic
# ---------------------------------------------------------------------------

def halves_of(pmax: int) -> int:
    """NH: the 32-bit halves a constant of the tile takes (its widest prime)."""
    return 2 if pmax >> 32 else 1


def c1_of(w, p, pinv):
    """c1 = 2^32 R mod p from the weights w [P, J] (w_j = R^(j+1) mod p):
    mont_mul(2^32 mod p, w_1), 2^32 mod p = mont_reduce(w0 2^32); with one
    weight, w_0 doubled 32 times."""
    w0 = w[:, 0]
    if w.shape[1] > 1:
        return mont_mul(mont_reduce(w0 >> U(32), w0 << U(32), p, pinv), w[:, 1], p, pinv)
    c1 = w0.copy()
    for _ in range(32):
        c1 = addmod(c1, c1, p)
    return c1


def limb_consts(w, idx, c1, p, pinv):
    """c_i = 2^(32 i) R mod p for the limbs idx: w_(i/2), times c1 (mont_mul)
    for an odd limb; [P, len(idx)]."""
    idx = np.asarray(idx)
    wj = w[:, idx // 2]
    odd = mont_mul(wj, c1[:, None], p[:, None], pinv[:, None])
    return np.where((idx & 1) == 1, odd, wj)


def pow2_src(w, src_bits, K, c1, p, pinv):
    """2^src_bits mod p = mont_reduce(c_f 2^e), src_bits = 32 f + e, f < K."""
    f = min(src_bits // 32, K - 1)
    e = src_bits - 32 * f
    c = limb_consts(w, [f], c1, p, pinv)[:, 0]
    hi = c >> U(64 - e) if e else np.zeros_like(c)
    with np.errstate(over="ignore"):
        return mont_reduce(hi, c << U(e), p, pinv)


def mad_128(a, x, c, nh):
    """rns.cu mad_128: a (four 32-bit words, u64 arrays) += x c by the PTX
    carry chain, each word wrapping at 2^32 as the register does."""
    def add(u, v, cf=U(0)):
        t = u + v + cf
        return t & M32, t >> U(32)
    p0 = x * (c & M32)
    a[0], cf = add(a[0], p0 & M32)
    a[1], cf = add(a[1], p0 >> U(32), cf)
    if nh == 1:
        a[2] = (a[2] + cf) & M32
        return
    p1 = x * (c >> U(32))
    a[2], cf = add(a[2], p1 >> U(32), cf)
    a[3] = (a[3] + cf) & M32
    a[1], cf = add(a[1], p1 & M32)
    a[2], cf = add(a[2], U(0), cf)
    a[3] = (a[3] + cf) & M32


def stage(x, neg, src_bits):
    """The staged limbs: the low 32 bits of each word, a negative row's
    limbs masked to src_bits."""
    x = x & M32
    if not src_bits:
        return x
    full, rem = divmod(src_bits, 32)
    li = np.arange(x.shape[-1])
    keep = np.where(li < full, M32, U((1 << rem) - 1) if rem else U(0))
    keep = np.where(li > full, U(0), keep)
    return np.where(neg[:, None], x & keep, x)


def decompose_rows(x, w, p, pinv, src_bits=0):
    """One tile's arithmetic: x u64 [rows, K] (words), w u64 [P, J], p and
    pinv [P] -> residues [P, rows], and NH."""
    rows, K = x.shape
    neg = np.zeros(rows, dtype=bool)
    if src_bits:
        hb = src_bits - 1
        neg = ((x[:, hb // 32] >> U(hb % 32)) & U(1)) == 1
    xs = stage(x, neg, src_bits)
    nh = halves_of(int(p.max()))
    c1 = c1_of(w, p, pinv)
    c = limb_consts(w, np.arange(K), c1, p, pinv)                  # [P, K]
    r = np.zeros((len(p), rows), dtype=U)
    with np.errstate(over="ignore"):
        for g0 in range(0, K, DEC_GROUP):
            a = [np.zeros((len(p), rows), dtype=U) for _ in range(4)]
            for i in range(g0, min(K, g0 + DEC_GROUP)):
                mad_128(a, xs[None, :, i], c[:, i:i + 1], nh)
            lo, hi = (a[1] << U(32)) | a[0], (a[3] << U(32)) | a[2]
            r = addmod(r, mont_reduce(hi, lo, p[:, None], pinv[:, None]), p[:, None])
    if src_bits:
        t = pow2_src(w, src_bits, K, c1, p, pinv)
        r = np.where(neg[None, :], submod(r, t[:, None], p[:, None]), r)
    return r, nh


# ---------------------------------------------------------------------------
# decompose's tensor-core route
# ---------------------------------------------------------------------------

def limb_bytes(xs):
    """Staged limbs u64 [rows, K] (each < 2^32) -> the A operand u8 [rows,
    4K]: depth j holds byte j % 4 of limb j / 4."""
    assert (xs >> U(32) == 0).all()
    return np.ascontiguousarray(xs.astype("<u4")).view(np.uint8).reshape(xs.shape[0], -1)


def fold(s, nb: int):
    """A prime's nb s32 byte-column sums s [..., nb] (int64, each < 2^31) ->
    V = sum_k s_k 2^(8 k) as (hi, lo) u64, as the kernel folds them: a_i =
    s_2i + 2^8 s_2i+1, then the a_i 16 bits apart, with their carries."""
    s = np.asarray(s).astype(U)
    a = [s[..., 2 * i] + (s[..., 2 * i + 1] << U(8)) for i in range(nb // 2)]
    with np.errstate(over="ignore"):
        lo, hi = a[0] + (a[1] << U(16)), np.zeros_like(a[0])
        if nb == 8:
            hi = (a[1] >> U(48)) + (lo < (a[1] << U(16))).astype(U)
            for i, sh in ((2, 32), (3, 48)):
                x = a[i] << U(sh)
                lo = lo + x
                hi = hi + (a[i] >> U(64 - sh)) + (lo < x).astype(U)
    return hi, lo


def decompose_mma_rows(x, table, nb, w, p, pinv, src_bits=0):
    """The tensor-core route's arithmetic on one slab: x u64 [rows, K] (words),
    table u8 [nb P, depth] (rns_cuda.decomp_byte_table), w u64 [P, J] and p,
    pinv [P] -> (residues [P, rows], the largest column sum)."""
    rows, K = x.shape
    neg = np.zeros(rows, dtype=bool)
    if src_bits:
        hb = src_bits - 1
        neg = ((x[:, hb // 32] >> U(hb % 32)) & U(1)) == 1
    a = limb_bytes(stage(x, neg, src_bits))
    # the depth walked: 32 bytes at a time, the bytes past 4K zero
    walked = -(-4 * K // 32) * 32
    assert walked <= table.shape[1], "the table is shallower than the walk"
    a = np.pad(a, ((0, 0), (0, walked - 4 * K)))
    cols = column_sums(a, table, nb * len(p)).reshape(rows, len(p), nb)
    hi, lo = fold(cols, nb)                                          # [rows, P]
    assert (hi < p[None, :]).all(), "V's high word past p"
    r = mont_reduce(hi, lo, p[None, :], pinv[None, :]).T
    if src_bits:
        t = pow2_src(w, src_bits, K, c1_of(w, p, pinv), p, pinv)
        r = np.where(neg[None, :], submod(r, t[:, None], p[:, None]), r)
    return r, int(cols.max(initial=0))


# ---------------------------------------------------------------------------
# the digit product's arithmetic
# ---------------------------------------------------------------------------

def byte_planes(x, nb: int):
    """Residues x u64 [rows, dim] (each < 2^(8 nb)) -> the A operand u8
    [rows, nb dim]: column d nb + t holds byte t of x_d, the residue's own
    little-endian bytes, as the kernel copies them."""
    assert nb == 8 or (x >> U(8 * nb) == 0).all(), "a residue past nb bytes"
    b = np.ascontiguousarray(x, dtype="<u8").view(np.uint8).reshape(x.shape + (8,))
    return b[..., :nb].reshape(x.shape[0], -1)


def column_sums(a, table, cols: int):
    """The s32 byte-column sums of the product: a u8 [rows, depth'] against
    the table's first `cols` rows (u8 [cols, depth >= depth']) -> int64
    [rows, cols], each checked below 2^31 (the mma's s32 accumulator)."""
    b = table[:cols, :a.shape[1]].astype(np.int64)
    out = a.astype(np.int64) @ b.T
    assert (out < 2**31).all(), "a byte-column sum past s32"
    return out


def combine16(cols):
    """Byte columns 2j and 2j + 1 -> 16-bit digit sum j = B_2j + 256 B_2j+1."""
    return cols[..., 0::2] + (cols[..., 1::2] << 8)


def launch_shape(kd: int):
    """(wn, bm, bn): warps across the columns, a block's coefficients and
    byte columns (rns.cu gpqhe_rns_digit_sums)."""
    wn = 1 if 2 * kd <= DS_WARP_N else 2 if 2 * kd <= 2 * DS_WARP_N else 4
    bn = DS_WARP_N * wn
    return wn, DS_TILE // bn, bn


def af_in_order(x, inv_p, nb: int, bm: int):
    """af of each row as the kernel sums it: thread u of the row's qs threads
    adds y_d / p_d of the primes u, u + qs, ... of each chunk, chunk after
    chunk, then the threads' sums in order (f64 products and sums; the card
    may contract them into FMAs)."""
    rows, dim = x.shape
    dcp, qs = DS_DEPTH // nb, DS_WARPS * 32 // bm
    terms = x.view(np.int64).astype(np.float64) * inv_p[None, :]
    parts = []
    for uu in range(qs):
        ap = np.zeros(rows)
        for d0 in range(0, dim, dcp):
            for d in range(d0 + uu, min(d0 + dcp, dim), qs):
                ap = ap + terms[:, d]
        parts.append(ap)
    out = parts[0]
    for ap in parts[1:]:
        out = out + ap
    return out


def fetch_order(bm: int, nb: int):
    """(row, prime of the chunk) of each residue copy of a chunk in the order
    the block's threads issue them (thread i: copies i, i + 256, ...): 16 / nb
    neighbouring lanes a row's 16-byte run, then the next row."""
    e_ = 16 // nb
    idx = np.arange(bm * (DS_DEPTH // nb))
    e, rest = idx % e_, idx // e_
    return rest % bm, (rest // bm) * e_ + e


# ---------------------------------------------------------------------------
# memory behind the wrappers' pointers
# ---------------------------------------------------------------------------

def _mem(ptr, count, ctype=ctypes.c_uint64):
    if not count:
        return np.zeros(0, dtype=np.float64 if ctype is ctypes.c_double else U)
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _strided(ptr, sizes, strides, ctype=ctypes.c_uint64):
    """The view [sizes] with element strides (>= 0) of the memory at ptr."""
    if 0 in sizes:
        return np.zeros(sizes, dtype=np.float64 if ctype is ctypes.c_double else U)
    ext = 1 + sum((n - 1) * s for n, s in zip(sizes, strides))
    base = _mem(ptr, ext, ctype)
    item = base.itemsize
    return np.lib.stride_tricks.as_strided(base, sizes, [s * item for s in strides])


class ModelLib:
    """The library's decompose and digit_sums entries, run by the model;
    each call appends what it did to `plans`."""

    def __init__(self, grid_z: int = GRID_Z, sms: int = SMS):
        self.grid_z, self.sms = grid_z, sms
        self.plans = []

    def gpqhe_rns_decompose(self, S, n, K, ss, sn, dim, J, out, a, w, ps, psd, pinv, pvd,
                            src_bits, stream):
        if K < 1:
            return 1                                # cudaErrorInvalidValue
        A = _strided(a, (S, n, K), (ss, sn, 1))
        W = _mem(w, dim * J).reshape(dim, J)
        P = _strided(ps, (dim,), (psd,)).astype(U)
        V = _strided(pinv, (dim,), (pvd,)).astype(U)
        O = _mem(out, S * dim * n).reshape(S, dim, n)
        seen = np.zeros((S, dim, n), dtype=np.int64)
        gx, gy, gz = -(-n // DEC_ROWS), -(-dim // DEC_PRIMES), min(S, self.grid_z)
        lane, j = np.meshgrid(np.arange(32), np.arange(2), indexing="ij")
        rr = (lane + 32 * j).reshape(-1)                           # a tile's rows by thread
        warp, e = np.meshgrid(np.arange(DEC_WARPS), np.arange(2), indexing="ij")
        dl = (warp + DEC_WARPS * e).reshape(-1)                    # a tile's primes by thread
        nhs = set()
        for by in range(gy):
            d0 = by * DEC_PRIMES
            np_ = min(DEC_PRIMES, dim - d0)
            live_d = dl[dl < np_]
            for bz in range(gz):
                for s in range(bz, S, gz):
                    # the whole slab's rows at once: the arithmetic does not
                    # depend on the block a row is in
                    res, nh = decompose_rows(np.ascontiguousarray(A[s]), W[d0:d0 + np_],
                                             P[d0:d0 + np_], V[d0:d0 + np_], src_bits)
                    nhs.add(nh)
                    for bx in range(gx):
                        r0 = bx * DEC_ROWS
                        live_r = rr[rr < min(DEC_ROWS, n - r0)]
                        idx = (s, d0 + live_d[:, None], r0 + live_r[None, :])
                        O[idx] = res[live_d[:, None], r0 + live_r[None, :]]
                        np.add.at(seen, idx, 1)
        assert (seen == 1).all(), "an output word written other than once"
        self.plans.append({"entry": "decompose", "grid": (gx, gy, gz), "tiles": gy,
                           "chunks": -(-K // DEC_KC), "groups": -(-K // DEC_GROUP),
                           "nh": nhs, "partial_block": n % DEC_ROWS != 0, "slab_loop": S > gz,
                           "signed": bool(src_bits)})
        return 0

    def gpqhe_rns_decompose_mma(self, S, n, K, ss, sn, dim, J, nb, out, a, w, ps, psd, pinv, pvd,
                                src_bits, table, tdepth, stream):
        if K < 1 or nb not in (4, 8) or tdepth % DS_DEPTH or 4 * K > tdepth:
            return 1                                # cudaErrorInvalidValue
        A = _strided(a, (S, n, K), (ss, sn, 1))
        W = _mem(w, dim * J).reshape(dim, J)
        P = _strided(ps, (dim,), (psd,)).astype(U)
        V = _strided(pinv, (dim,), (pvd,)).astype(U)
        tab = _mem(table, nb * dim * tdepth, ctypes.c_uint8).reshape(nb * dim, tdepth)
        O = _mem(out, S * dim * n).reshape(S, dim, n)
        tiles_k, tiles_c = -(-n // DM_ROWS), -(-nb * dim // DM_COLS)
        items = S * tiles_k * tiles_c
        if items == 0:
            return 0
        blocks = min(items, DS_BLOCKS_AN_SM * self.sms)
        seen = np.zeros((S, dim, n), dtype=np.int64)
        # the warps' tiles: two down, four across; each stages 16 rows of its
        # 64 columns' sums at a time in the stage just worked
        w_ = np.arange(DS_WARPS)
        wr, wc = (w_ // 4) * DS_WARP_M, (w_ % 4) * DS_WARP_N
        assert DS_WARPS * 16 * (DS_WARP_N + DM_OUT_PAD) * 4 <= (DM_ROWS + DM_COLS) * (DS_DEPTH
                                                                                     + DS_PAD)
        # the staging loads: lane l of warp w takes limb 32 ch + l of rows w + 8 u
        lane, warp, u = np.meshgrid(np.arange(32), np.arange(DS_WARPS), np.arange(8),
                                    indexing="ij")
        assert sorted(zip((warp + 8 * u).ravel(), lane.ravel())) == [
            (r, l) for r in range(DM_ROWS) for l in range(DM_CHUNK)], "a staged limb missed"
        walked = [0] * blocks
        slabs, maxcol, partial_cols = {}, 0, False
        for item in range(items):
            walked[item % blocks] += 1          # block item % blocks takes it
            q, tc = divmod(item, tiles_c)
            s, tk = divmod(q, tiles_k)
            c0, k0 = tc * DM_COLS, tk * DM_ROWS
            cols, rows = min(nb * dim - c0, DM_COLS), min(n - k0, DM_ROWS)
            if s not in slabs:                  # the slab's arithmetic, all its rows at once
                res, mc = decompose_mma_rows(np.ascontiguousarray(A[s]), tab, nb, W, P, V,
                                             src_bits)
                maxcol = max(maxcol, mc)
                slabs = {s: res}
            res = slabs[s]
            for r0, c1 in zip(wr, wc):
                np_ = max(0, min(cols - c1, DS_WARP_N)) // nb
                partial_cols |= 0 < np_ < DS_WARP_N // nb
                e0 = (c0 + c1) // nb
                for f in range(2):
                    k = k0 + r0 + 16 * f + np.arange(16)
                    k = k[k < k0 + rows]
                    d = e0 + np.arange(np_)
                    idx = (s, d[:, None], k[None, :])
                    O[idx] = res[d[:, None], k[None, :]]
                    np.add.at(seen, idx, 1)
        assert (seen == 1).all(), "an output word written other than once"
        self.plans.append({"entry": "decompose_mma", "blocks": blocks, "nb": nb,
                           "col_blocks": tiles_c, "chunks": -(-4 * K // DS_DEPTH),
                           "partial_block": n % DM_ROWS != 0, "partial_cols": bool(partial_cols),
                           "slab_loop": max(walked) > 1, "signed": bool(src_bits),
                           "max_column": maxcol})
        return 0

    def gpqhe_rns_digit_sums(self, S, dim, n, nb, kd, sums, af, y, ys, yd, yk, scale, scd, ps,
                             psd, pinv, pvd, inv_p, ipd, table, tdepth, stream):
        if kd < 1 or tdepth % DS_DEPTH or nb * dim > tdepth or nb not in (4, 8):
            return 1                                # cudaErrorInvalidValue
        if S * n == 0:
            return 0
        yv = _strided(y, (S, dim, n), (ys, yd, yk))
        So = _mem(sums, S * n * kd).reshape(S, n, kd)
        afo = _mem(af, S * n, ctypes.c_double).reshape(S, n)
        ip = _strided(inv_p, (dim,), (ipd,), ctypes.c_double)
        tab = _mem(table, 2 * kd * tdepth, ctypes.c_uint8).reshape(2 * kd, tdepth)
        if scale:
            sc, P, V = (_strided(q, (dim,), (st,)).astype(U)
                        for q, st in ((scale, scd), (ps, psd), (pinv, pvd)))
        wn, bm, bn = launch_shape(kd)
        tiles_k, tiles_c = -(-n // bm), -(-2 * kd // bn)
        items = S * tiles_k * tiles_c
        blocks = min(items, DS_BLOCKS_AN_SM * self.sms)
        chunks = -(-nb * dim // DS_DEPTH)
        seen_s = np.zeros((S, n, kd), dtype=np.int64)
        seen_af = np.zeros((S, n), dtype=np.int64)
        # the warps' tiles: wn across the columns, 8 // wn down the rows
        w = np.arange(DS_WARPS)
        wr, wc = (w // wn) * DS_WARP_M, (w % wn) * DS_WARP_N
        row, prime = fetch_order(bm, nb)
        assert sorted(zip(row, prime)) == [(a, b) for a in range(bm)
                                           for b in range(DS_DEPTH // nb)], "a copy missed"
        maxcol, slabs = 0, {}
        walked = [0] * blocks
        for item in range(items):
            walked[item % blocks] += 1          # block item % blocks takes it
            q, tc = divmod(item, tiles_c)
            s, tk = divmod(q, tiles_k)
            c0, k0 = tc * bn, tk * bm
            cols = min(2 * kd - c0, bn)
            if s not in slabs:                  # the slab's arithmetic, all its rows at once
                x = np.ascontiguousarray(yv[s].T).astype(U)             # [n, dim]
                if scale:
                    x = mont_mul(x, sc[None, :], P[None, :], V[None, :])
                a = byte_planes(x, nb)
                acc = np.zeros((n, 2 * kd), dtype=np.int64)
                for ch in range(chunks):
                    lo, hi = ch * DS_DEPTH, min(nb * dim, (ch + 1) * DS_DEPTH)
                    acc += column_sums(a[:, lo:hi], tab[:, lo:hi], 2 * kd)
                assert (acc < 2**31).all(), "a byte-column sum past s32"
                maxcol = max(maxcol, int(acc.max(initial=0)))
                slabs = {s: (combine16(acc), af_in_order(x, ip, nb, bm))}
            d16, af_s = slabs[s]
            live = np.clip(-(-(cols - wc) // 8), 0, DS_WARP_N // 8)
            covered = {(a_, c) for a0, c1, lv in zip(wr, wc, live)
                       for a_ in range(a0, a0 + DS_WARP_M) for c in range(c1, c1 + 8 * lv)}
            assert all((a_, c) in covered for a_ in range(bm) for c in range(cols)), \
                "a byte column of the tile left to no warp"
            # the tile's epilogue, each warp's 16 rows of 32 sums at a time
            # staged in the stage just worked: the rows below n, the cols / 2
            # digit sums
            assert DS_WARPS * 16 * (DS_WARP_N // 2 + DS_OUT_PAD) * 8 <= \
                (bm + bn) * (DS_DEPTH + DS_PAD)
            k = np.arange(k0, min(n, k0 + bm))
            So[s, k, c0 // 2:c0 // 2 + cols // 2] = d16[k, c0 // 2:c0 // 2 + cols // 2]
            seen_s[s, k, c0 // 2:c0 // 2 + cols // 2] += 1
            if c0 == 0:
                afo[s, k] = af_s[k]
                seen_af[s, k] += 1
        assert (seen_s == 1).all() and (seen_af == 1).all(), \
            "an output word written other than once"
        self.plans.append({"entry": "digit_sums", "blocks": blocks, "wn": wn, "bm": bm,
                           "nb": nb, "chunks": chunks, "col_blocks": tiles_c,
                           "partial_depth": nb * dim % DS_DEPTH != 0,
                           "partial_block": n % bm != 0, "scaled": bool(scale),
                           "slab_loop": max(walked) > 1, "max_column": maxcol})
        return 0
