"""K8, the four-step NTT's split and combine (csrc/ntt4.cu), in numpy, for
the CPU tests: each launch's work split as the kernel makes it (which block
takes which slab and tile, which thread of it which words; the transposing
split's shared-memory tile, written by the load and read across) and its
arithmetic as the kernel runs it (the Montgomery products of mont.cuh, the
digit planes, the anti-diagonal sums in f64, the carry assembly into NL
limbs), on native u64 words, vectorised over the threads of a launch.

ModelLib stands in for the built library at its C interface: the wrappers
of ops/ntt4_cuda.py call it with the same arguments (pointers, counts) they
give the kernels, and it reads and writes the tensors' memory through those
pointers (CPU tensors).  The constants below mirror ntt4.cu's #defines
(held equal by tests/test_torch_ntt4.py).
"""

import ctypes

import numpy as np

from torch_rns_model import _mem, addmod, mont_mul

U = np.uint64
SPLIT_TILE = 32           # ntt4.cu: a split block's tile, 32 x 32 words
SPLIT_ROWS = 8            # ntt4.cu: its threads 32 x 8, four words each
COMBINE_THREADS = 256     # ntt4.cu: a combine block's words
GRID_Y = 65535


def limbs_of(P: int) -> int:
    """NL: the u64 limbs of sum_w S_w 2^(16 w) (ntt4.cu's constexpr)."""
    return (16 * (2 * P - 2) + 106) // 64


def split_threads(B, dim, R, C, transpose):
    """Every (slab, k, j) a split launch writes, one row a (block, thread,
    word) in the kernel's order, and for the transposing split the words its
    tile loads wrote: a mask over (slab, r, c)."""
    tiles_r, tiles_c = -(-R // SPLIT_TILE), -(-C // SPLIT_TILE)
    s, blk, ty, tx, i = np.meshgrid(np.arange(B * dim), np.arange(tiles_r * tiles_c),
                                    np.arange(SPLIT_ROWS), np.arange(SPLIT_TILE),
                                    np.arange(SPLIT_TILE // SPLIT_ROWS), indexing="ij")
    s, blk, ty, tx, i = (a.reshape(-1) for a in (s, blk, ty, tx, i))
    row = ty + SPLIT_ROWS * i                    # the loop variable i of the kernel
    tr, tc = blk // tiles_c, blk % tiles_c
    r0, c0 = tr * SPLIT_TILE, tc * SPLIT_TILE
    K, J = (C, R) if transpose else (R, C)
    k = (c0 if transpose else r0) + row
    j = (r0 if transpose else c0) + tx
    loaded = None
    if transpose:
        r, c = r0 + row, c0 + tx
        ok = (r < R) & (c < C)
        loaded = np.zeros((B * dim, R, C), dtype=bool)
        loaded[s[ok], r[ok], c[ok]] = True
    keep = (k < K) & (j < J)
    return s[keep], k[keep], j[keep], loaded


def combine_threads(B, dim, M, J):
    """Every (slab, e) a combine launch writes, one row a thread."""
    n = M * J
    s, blk, t = np.meshgrid(np.arange(B * dim), np.arange(-(-n // COMBINE_THREADS)),
                            np.arange(COMBINE_THREADS), indexing="ij")
    e = (blk * COMBINE_THREADS + t).reshape(-1)
    s = s.reshape(-1)
    keep = e < n
    return s[keep], e[keep]


class ModelLib:
    """The library's split and combine entries, run by the model; each call
    appends what it did to `plans`."""

    def __init__(self):
        self.plans = []

    def gpqhe_ntt4_split(self, out, x, B, dim, R, C, P, transpose, tab, ps, pinv, stream):
        assert B * dim <= GRID_Y and 1 <= P <= 4
        K, J = (C, R) if transpose else (R, C)
        xs = _mem(x, B * dim * R * C).reshape(B * dim, R, C)
        o = _mem(out, dim * K * B * P * J, ctypes.c_double)
        pv, qv = _mem(ps, dim), _mem(pinv, dim)
        s, k, j, loaded = split_threads(B, dim, R, C, transpose)
        b, d = s // dim, s % dim
        if transpose:
            # the word read from the tile is (r, c) = (j, k), written by the load
            assert loaded[s, j, k].all(), "a thread reads a tile word no load wrote"
            w = xs[s, j, k]
        else:
            w = xs[s, k, j]
        if tab is not None:
            t = _mem(tab, dim * K * J).reshape(dim, K, J)
            w = mont_mul(w, t[d, k, j], pv[d], qv[d])
        base = (((d * K + k) * B + b) * P) * J + j
        seen = np.zeros(o.size, dtype=np.int64)
        for u in range(P):
            idx = base + u * J
            o[idx] = ((w >> U(16 * u)) & U(0xFFFF)).astype(np.float64)
            np.add.at(seen, idx, 1)
        assert (seen == 1).all(), "split writes every plane word once"
        self.plans.append(("split", B, dim, R, C, P, transpose, tab is not None))
        return 0

    def gpqhe_ntt4_combine(self, out, y, B, dim, M, logJ, P, tab, scale, ps, pinv, cpow,
                           stream):
        assert B * dim <= GRID_Y and 1 <= P <= 4
        J = 1 << logJ
        n = M * J
        yy = _mem(y, dim * P * M * B * P * J, ctypes.c_double)
        o = _mem(out, B * dim * n)
        pv, qv, cp = _mem(ps, dim), _mem(pinv, dim), _mem(cpow, 3 * dim).reshape(dim, 3)
        s, e = combine_threads(B, dim, M, J)
        b, d = s // dim, s % dim
        r, c = e >> logJ, e & (J - 1)
        row = B * P * J
        S = [np.zeros(e.size) for _ in range(2 * P - 1)]
        for v in range(P):
            for u in range(P):
                S[u + v] = S[u + v] + yy[((d * P + v) * M + r) * row + (b * P + u) * J + c]
        assert all((x < 2.0 ** 53).all() and (x == np.floor(x)).all() for x in S)
        NL = limbs_of(P)
        L = [np.zeros(e.size, dtype=U) for _ in range(NL)]
        carry = np.zeros(e.size, dtype=U)
        for w in range(4 * NL):
            cur = carry + (S[w].astype(U) if w < 2 * P - 1 else U(0))
            L[w >> 2] |= (cur & U(0xFFFF)) << U(16 * (w & 3))
            carry = cur >> U(16)
        assert not carry.any(), "the value fits NL limbs"
        p, q = pv[d], qv[d]
        acc = mont_mul(L[0], cp[d, 0], p, q)
        for g in range(1, NL):
            acc = addmod(acc, mont_mul(L[g], cp[d, g], p, q), p)
        if tab is not None:
            acc = mont_mul(acc, _mem(tab, dim * n).reshape(dim, n)[d, e], p, q)
        if scale is not None:
            acc = mont_mul(acc, _mem(scale, dim)[d], p, q)
        idx = s * n + e
        assert np.unique(idx).size == idx.size == o.size, "combine writes every word once"
        o[idx] = acc
        self.plans.append(("combine", B, dim, M, J, P, tab is not None, scale is not None))
        return 0
