"""K8, the four-step NTT's fused stage (csrc/ntt4.cu), in numpy, for the CPU
tests: each launch's work split as the kernel makes it (which block takes
which slab and output tile; which thread copies which 16-byte chunk of W's
byte planes and which warp and lane cut which four words of X into them,
each shared byte written once; the ldmatrix row addresses of every lane
and the m16n8k32 fragment map, so that each tensor-core product is
assembled from what each lane holds; which lane writes which outputs) and
its arithmetic as the kernel runs it (the pre-multiply, a warp's 2 P8 - 1
s32 anti-diagonal sums of its fragment, their groups of four in u64 and
the Montgomery folds against c32, the post and scale multiplies of
mont.cuh), on native u64 words, vectorised over the blocks, warps and
lanes of a launch.

ModelLib stands in for the built library at its C interface: the wrapper
of ops/ntt4_cuda.py calls it with the same arguments (pointers, counts) it
gives the kernel, and it reads and writes the tensors' memory through those
pointers (CPU tensors).  The constants below mirror ntt4.cu's #defines
(held equal by tests/test_torch_ntt4.py).
"""

import ctypes

import numpy as np

from torch_rns_model import _mem, addmod, mont_mul

U = np.uint64
THREADS = 256       # ntt4.cu NTT4_THREADS: a block, 8 warps
TILE_M8 = 64        # NTT4_TILE_M8: a block's output rows at P8 = 8, at most
TILE_M4 = 128       # NTT4_TILE_M4: at P8 <= 4
TILE_M_MIN = 32     # NTT4_TILE_M_MIN: the fewest
TILE_J = 32         # NTT4_TILE_J: its output columns
WARP_M = 16         # NTT4_WARP_M: a warp's outputs at a time, one m16n8 fragment
WARP_J = 8          # NTT4_WARP_J
PAD = 16            # NTT4_PAD: bytes past a plane row's K in shared memory
MAX_K = 256         # NTT4_MAX_K
LOAD_ITEMS = 4      # NTT4_LOAD_ITEMS: X items a warp loads before it cuts any
GRID_Y = 65535
WARPS = THREADS // 32
FJ = TILE_J // WARP_J
S32_MAX = 2 ** 31 - 1


def folds_of(P8: int) -> int:
    """The Montgomery folds: groups of four among the 2 P8 - 1 anti-diagonals."""
    return (2 * P8 + 2) // 4


def pass_width(P8: int) -> int:
    """The anti-diagonal sums a warp keeps at once (ntt4.cu's PW): 8 at
    P8 = 8 (two passes over k), all 2 P8 - 1 below."""
    return 8 if P8 == 8 else 2 * P8 - 1


def max_diagonal_sum(P8: int, K: int) -> int:
    """The largest anti-diagonal sum: at w = P8 - 1, P8 pairs of planes,
    each K products of two bytes."""
    return P8 * K * 255 ** 2


def tile_rows(P8, K, J, slabs, sms):
    """ntt4.cu's tile_rows: a block's rows of W, 64 at P8 = 8 and 128
    below, halved (to 32 at the fewest) while half would cover M or the
    grid would give an SM fewer than two blocks."""
    tm = TILE_M8 if P8 == 8 else TILE_M4
    while tm > TILE_M_MIN and (tm // 2 >= K or -(-K // tm) * -(-J // TILE_J) * slabs < 2 * sms):
        tm //= 2
    return tm


def stage_blocks(B, dim, K, J, tile_m):
    """Every block of a launch, in launch order (blockIdx.x fastest):
    its slab, prime, first output row and first output column."""
    tiles_m, tiles_j = -(-K // tile_m), -(-J // TILE_J)
    by, bx = np.meshgrid(np.arange(B * dim), np.arange(tiles_m * tiles_j), indexing="ij")
    bx, by = bx.reshape(-1), by.reshape(-1)
    d, b = by // B, by % B
    tm, tj = bx // tiles_j, bx % tiles_j
    return b * dim + d, d, tm * tile_m, tj * TILE_J


def _geometry(K):
    KP = (K + 31) & ~31
    return KP, KP + PAD


def load_w(w, d, m0, K, P8, TILE_M):
    """Each block's W planes in shared memory, [blocks, P8 TILE_M KS] bytes,
    as the threads' copies write them (16 bytes a copy, or 4 for K < 16),
    zeros past M and K; asserts that every byte the products read is
    written once."""
    M = K
    KP, KS = _geometry(K)
    width = 16 if K % 16 == 0 else 4
    per_row = KP // width
    i = np.arange(P8 * TILE_M * per_row)
    tid = i % THREADS                          # the thread whose loop takes copy i
    assert np.array_equal(tid + THREADS * (i // THREADS), i)
    r, c = i // per_row, i % per_row
    v, row = r // TILE_M, r % TILE_M
    img = np.full((d.size, P8 * TILE_M * KS), 0xEE, dtype=np.uint8)   # unwritten bytes
    seen = np.zeros(P8 * TILE_M * KS, dtype=np.int64)
    for e in range(width):
        np.add.at(seen, r * KS + width * c + e, 1)
        m = m0[:, None] + row[None, :]
        k = width * c + e
        ok = (m < M) & (k < K)[None, :]
        val = w[d[:, None], v[None, :], np.minimum(m, M - 1), np.minimum(k, K - 1)[None, :]]
        img[:, r * KS + width * c + e] = np.where(ok, val, 0)
    read = (np.arange(P8 * TILE_M * KS) % KS) < KP
    assert (seen[read] == 1).all(), "a W byte the products read is not written once"
    return img


def load_x(xs, s, d, j0, K, J, P8, transpose, pre, p, q):
    """Each block's X planes, [blocks, P8 TILE_J KS] bytes: warp item it
    (8 columns x 16 k) at warp it % WARPS, in its load group of LOAD_ITEMS
    items (it0 = warp + WARPS LOAD_ITEMS n, item it0 + c WARPS), lane
    (column lane % 8, k-group lane / 8), 4 words of one column times pre,
    byte u of word i at plane u, column, k = 4 kq + i; asserts each byte
    written once."""
    KP, KS = _geometry(K)
    items = (TILE_J // 8) * (KP // 16)
    warp, n, c, lane = np.meshgrid(np.arange(WARPS), np.arange(-(-items // (WARPS * LOAD_ITEMS))),
                                   np.arange(LOAD_ITEMS), np.arange(32), indexing="ij")
    it = (warp + WARPS * LOAD_ITEMS * n + c * WARPS).reshape(-1)
    lane = lane.reshape(-1)[it < items]
    it = it[it < items]
    assert np.array_equal(np.sort(np.unique(it)), np.arange(items))
    jb, kb = it % (TILE_J // 8), it // (TILE_J // 8)
    jl, kq = jb * 8 + (lane & 7), kb * 4 + (lane >> 3)
    img = np.full((s.size, P8 * TILE_J * KS), 0xEE, dtype=np.uint8)
    seen = np.zeros(P8 * TILE_J * KS, dtype=np.int64)
    j = j0[:, None] + jl[None, :]
    for i in range(4):
        k = (4 * kq + i)[None, :]
        ok = (k < K) & (j < J)
        kc, jc = np.minimum(k, K - 1), np.minimum(j, J - 1)
        v = xs[s[:, None], jc * K + kc] if transpose else xs[s[:, None], kc * J + jc]
        if pre is not None:
            v = mont_mul(v, pre[d[:, None], kc * J + jc], p[d][:, None], q[d][:, None])
        v = np.where(ok, v, U(0))
        for u in range(P8):
            at = (u * TILE_J + jl) * KS + 4 * kq + i
            img[:, at] = ((v >> U(8 * u)) & U(0xFF)).astype(np.uint8)
            np.add.at(seen, at, 1)
    read = (np.arange(P8 * TILE_J * KS) % KS) < KP
    assert (seen[read] == 1).all() and not seen[~read].any(), "an X byte not written once"
    return img


# the PTX fragment maps of mma.m16n8k32 with u8 operands, by lane (g = lane
# / 4, t = lane % 4), register and byte: A (16 x 32, row) register i byte e
# at row g + 8 (i % 2), column 4 t + e + 16 (i / 2); B (32 x 8, col)
# register i byte e at row 4 t + e + 16 i, column g; D register r at row
# g + 8 (r / 2), column 2 t + r % 2
_L = np.arange(32)
_G, _T = _L >> 2, _L & 3
A_ROW = _G[:, None, None] + 8 * (np.arange(4) % 2)[None, :, None] + 0 * np.arange(4)
A_COL = (4 * _T[:, None, None] + np.arange(4)[None, None, :]
         + 16 * (np.arange(4) // 2)[None, :, None])
B_ROW = 4 * _T[:, None, None] + np.arange(4)[None, None, :] + 16 * np.arange(2)[None, :, None]
B_COL = np.broadcast_to(_G[:, None, None], B_ROW.shape)
D_ROW = _G[:, None] + 8 * (np.arange(4) // 2)[None, :]
D_COL = 2 * _T[:, None] + (np.arange(4) % 2)[None, :]


def ldmatrix_x4(img, rows_addr):
    """ldmatrix.x4 of b16 8 x 8 matrices: matrix i's row r from the address
    lane 8 i + r gives; lane l receives register i = the 4 bytes at byte
    4 (l % 4) of matrix i's row l / 4.  img [blocks, bytes]; rows_addr
    [..., 32] byte addresses -> [blocks, ..., 32 lanes, 4 registers, 4 bytes]."""
    src = rows_addr[..., 8 * np.arange(4)[None, :] + (_L >> 2)[:, None]]   # [..., lane, reg]
    at = src[..., None] + 4 * _T[:, None, None] + np.arange(4)
    return img[:, at]


def mma(a, b):
    """m16n8k32 from the lanes' registers: a [..., 32, 4, 4], b [..., 32, 2, 4]
    bytes -> D by lane and register [..., 32, 4] (int64, exact)."""
    A = np.zeros(a.shape[:-3] + (16, 32), dtype=np.int64)
    Bm = np.zeros(b.shape[:-3] + (32, 8), dtype=np.int64)
    A[..., A_ROW, A_COL] = a
    Bm[..., B_ROW, B_COL] = b
    D = A @ Bm
    return D[..., D_ROW, D_COL]


class ModelLib:
    """The library's stage entry, run by the model; each call appends what
    it did to `plans`."""

    def __init__(self, sms: int = 1):
        self.sms = sms            # the card's SMs, for the tile choice
        self.plans = []
        self.max_sum = 0          # the largest s32 anti-diagonal sum seen

    def gpqhe_ntt4_stage(self, out, x, w8, B, dim, K, J, P8, transpose, pre, post, scale, ps,
                         pinv, c32, stream):
        assert B * dim <= GRID_Y and P8 in (2, 4, 8)
        assert 4 <= K <= MAX_K and K % 4 == 0 and J % 2 == 0
        M = K
        KP, KS = _geometry(K)
        xs = _mem(x, B * dim * K * J).reshape(B * dim, K * J)
        w = _mem(w8, dim * P8 * M * K, ctypes.c_uint8).reshape(dim, P8, M, K)
        p, q = _mem(ps, dim), _mem(pinv, dim)
        cw = _mem(c32, 4 * dim).reshape(dim, 4)
        tpre = None if pre is None else _mem(pre, dim * K * J).reshape(dim, K * J)
        tile_m = tile_rows(P8, K, J, B * dim, self.sms)
        FRAGS = (tile_m // WARP_M) * FJ         # a block's fragments, fragment f to warp f % WARPS
        s, d, m0, j0 = stage_blocks(B, dim, K, J, tile_m)
        wimg = load_w(w, d, m0, K, P8, tile_m)
        ximg = load_x(xs, s, d, j0, K, J, P8, transpose, tpre, p, q)
        # every fragment of a block, each taken by warp f % WARPS in its
        # loop (f = warp, warp + WARPS, ...), and each lane's ldmatrix rows:
        # [fragment, lane] byte addresses (B: two planes, the second by
        # lane / 16)
        warp, n = np.meshgrid(np.arange(WARPS), np.arange(FRAGS // WARPS), indexing="ij")
        f = (warp + WARPS * n).reshape(-1)
        assert np.array_equal(np.sort(f), np.arange(FRAGS))
        f, lane = np.meshgrid(np.sort(f), _L, indexing="ij")
        wm, wj = (f // FJ) * WARP_M, (f % FJ) * WARP_J
        a_lane = (wm + (lane & 7) + 8 * ((lane >> 3) & 1)) * KS + 16 * (lane >> 4)
        b_lane = ((lane >> 4) * TILE_J + wj + (lane & 7)) * KS + 16 * ((lane >> 3) & 1)
        shape = (s.size, FRAGS, 32, 4)
        NW, PW = 2 * P8 - 1, pass_width(P8)
        S = np.zeros((NW,) + shape, dtype=np.int64)
        for w0 in range(0, NW, PW):             # a pass: sums w0 .. w0 + PW - 1
            for k in range(0, KP, 32):
                bf = {}
                for u in range(0, P8, 2):
                    r = ldmatrix_x4(ximg, b_lane + u * TILE_J * KS + k)   # [blk, warp, lane, 4, 4]
                    bf[u], bf[u + 1] = r[..., 0:2, :], r[..., 2:4, :]
                for v in range(P8):
                    if v + P8 - 1 < w0 or v >= w0 + PW:
                        continue
                    a = ldmatrix_x4(wimg, a_lane + v * tile_m * KS + k)
                    for u in range(P8):
                        if w0 <= u + v < w0 + PW:
                            S[u + v] += mma(a, bf[u])
        assert (S >= 0).all() and (S <= S32_MAX).all(), "an s32 sum overflows"
        self.max_sum = max(self.max_sum, int(S.max()))
        # the folds: groups of four sums, each by one Montgomery product
        acc = np.zeros(shape, dtype=U)
        pd, qd = p[d].reshape(-1, 1, 1, 1), q[d].reshape(-1, 1, 1, 1)
        for g in range(folds_of(P8)):
            grp = sum(S[w].astype(U) << U(8 * (w - 4 * g))
                      for w in range(4 * g, min(4 * g + 4, 2 * P8 - 1)))
            assert (grp < U(1 << 52)).all()
            acc = addmod(acc, mont_mul(grp, cw[d, g].reshape(-1, 1, 1, 1), pd, qd), pd)
        # the epilogue: lane (g, t) register r at row g + 8 (r / 2), column 2 t + r % 2
        m = (m0.reshape(-1, 1, 1, 1) + wm.reshape(1, FRAGS, 32, 1)
             + D_ROW.reshape(1, 1, 32, 4))
        j = (j0.reshape(-1, 1, 1, 1) + wj.reshape(1, FRAGS, 32, 1)
             + D_COL.reshape(1, 1, 32, 4))
        sb = np.broadcast_to(s.reshape(-1, 1, 1, 1), shape)
        db = np.broadcast_to(d.reshape(-1, 1, 1, 1), shape)
        m, j = np.broadcast_to(m, shape), np.broadcast_to(j, shape)
        keep = (m < M) & (j < J)
        sb, db, m, j, r = sb[keep], db[keep], m[keep], j[keep], acc[keep]
        if post is not None:
            r = mont_mul(r, _mem(post, dim * M * J).reshape(dim, M * J)[db, m * J + j],
                         p[db], q[db])
        if scale is not None:
            r = mont_mul(r, _mem(scale, dim)[db], p[db], q[db])
        o = _mem(out, B * dim * M * J)
        idx = sb * (M * J) + m * J + j
        assert np.unique(idx).size == idx.size == o.size, "the stage writes every word once"
        o[idx] = r
        self.plans.append(("stage", B, dim, K, J, P8, bool(transpose), pre is not None,
                           post is not None, scale is not None, tile_m))
        return 0
