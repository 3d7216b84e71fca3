"""K4 decompose and K6's digit split (csrc/rns.cu) in numpy, for the CPU
tests of both kernels: each launch's work split as the kernel makes it
(which block takes which rows or coefficients and which tile of primes,
which lane and warp of it which outputs, the slab loop past 65535 blocks,
the staged chunks of 64 limbs, the 16-byte pairs) and its arithmetic as
the kernel runs it (the limb constants made from the weights, the 32 x
64-bit products summed in four 32-bit words by the PTX carry chain, one
Montgomery reduction a group of 256 limbs, the signed form), on native
u64 words, vectorised over rows.

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
SPLIT_WARPS = 8           # rns.cu: warps of a digit-split block
SPLIT_COEFS = 64          # rns.cu: coefficients of a digit-split block, two a lane
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
    """The library's decompose and digit_split entries, run by the model;
    each call appends what it did to `plans`."""

    def __init__(self, grid_z: int = GRID_Z):
        self.grid_z = grid_z
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

    def gpqhe_rns_digit_split(self, S, dim, n, nd, Y, af, y, ys, yd, yk, scale, scd, ps, psd,
                              pinv, pvd, inv_p, ipd, stream):
        yv = _strided(y, (S, dim, n), (ys, yd, yk))
        Yo = _mem(Y, S * nd * dim * n, ctypes.c_double).reshape(S, nd * dim, n)
        afo = _mem(af, S * n, ctypes.c_double).reshape(S, n)
        ip = _strided(inv_p, (dim,), (ipd,), ctypes.c_double)
        if scale:
            sc, P, V = (_strided(q, (dim,), (st,)).astype(U)
                        for q, st in ((scale, scd), (ps, psd), (pinv, pvd)))
        seen_y = np.zeros((S, nd * dim, n), dtype=np.int64)
        seen_af = np.zeros((S, n), dtype=np.int64)
        gx, gy = -(-n // SPLIT_COEFS), min(S, self.grid_z)
        pair = n % 2 == 0
        vload = pair and yk == 1 and yd % 2 == 0 and ys % 2 == 0 and y % 16 == 0
        lane = np.arange(32)
        for bx in range(gx):
            k = bx * SPLIT_COEFS + 2 * lane
            k0, k1 = k[k < n], k[k + 1 < n] + 1          # a lane's first and second word
            for by in range(gy):
                for s in range(by, S, gy):
                    part = np.zeros((SPLIT_WARPS, 32, 2))
                    for warp in range(SPLIT_WARPS):
                        for d in range(warp, dim, SPLIT_WARPS):
                            v = np.zeros((32, 2), dtype=U)
                            v[k < n, 0] = yv[s, d, k0]
                            v[k + 1 < n, 1] = yv[s, d, k1]
                            if scale:
                                v = mont_mul(v, sc[d], P[d], V[d])
                            part[warp] += v.view(np.int64).astype(np.float64) * ip[d]
                            for t in range(nd):
                                dig = ((v >> U(16 * t)) & U(0xFFFF)).astype(np.float64)
                                Yo[s, t * dim + d, k0] = dig[k < n, 0]
                                Yo[s, t * dim + d, k1] = dig[k + 1 < n, 1]
                                seen_y[s, t * dim + d, k0] += 1
                                seen_y[s, t * dim + d, k1] += 1
                    a = part[0].copy()
                    for warp in range(1, SPLIT_WARPS):
                        a += part[warp]
                    afo[s, k0] = a[k < n, 0]
                    afo[s, k1] = a[k + 1 < n, 1]
                    seen_af[s, k0] += 1
                    seen_af[s, k1] += 1
        assert (seen_y == 1).all() and (seen_af == 1).all(), \
            "an output word written other than once"
        self.plans.append({"entry": "digit_split", "grid": (gx, gy), "pair": pair,
                           "vload": vload, "partial_block": n % SPLIT_COEFS != 0,
                           "primes_a_warp": math.ceil(dim / SPLIT_WARPS), "nd": nd,
                           "scaled": bool(scale), "slab_loop": S > gy})
        return 0
