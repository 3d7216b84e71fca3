"""K5 (csrc/modmath.cu) in numpy, for the CPU tests of its elementwise
kernel: each launch's work split as mm_ew_kernel makes it (the block's
threads, the words a thread takes as 16-byte pairs, the aligned, constant
and word-by-word paths of every operand row, the row's tail, the loops over
the prime axis and over A past the grid's 65535) and its arithmetic as the
kernel runs it (mulmod by one Barrett reduction against the wrapper's
per-prime table, mont.cuh's Montgomery product, addmod and submod, every
precondition asserted on every word), on native u64 words, vectorised over
rows and threads.

ModelLib stands in for the built library at its C interface: the wrappers
of ops/modmath_cuda.py call it with the same arguments (pointers, strides,
counts) they give the kernels, and it reads and writes the tensors' memory
through those pointers (CPU tensors).  Its fused entries (the cross terms,
the key products, the sums) run the same arithmetic word by word.  The
constants below mirror modmath.cu's #defines (held equal by
tests/test_torch_modmath_kernel_model.py).
"""

import numpy as np

from torch_rns_model import _mem, _strided, umulhi

U = np.uint64
EW_THREADS = 256          # modmath.cu: threads of an elementwise block, at most
EW_PAIRS = 2              # modmath.cu: 16-byte pairs of words a thread takes
EW_WORDS = 2 * EW_PAIRS
GRID_Z = 65535            # the launches' largest grid.y / grid.z
OP_MONT_MUL, OP_MULMOD, OP_ADDMOD, OP_SUBMOD = range(4)
SUM_PLAIN, SUM_PRODUCTS, SUM_PRODUCTS_TIMES = range(3)


# ---------------------------------------------------------------------------
# mont.cuh on u64 arrays, each precondition asserted
# ---------------------------------------------------------------------------

def mont_reduce(hi, lo, p, pinv):
    """hi:lo R^-1 mod p in [0, p); the kernel's result is right only for hi < p."""
    assert (hi < p).all(), "mont_reduce needs hi < p"
    with np.errstate(over="ignore"):
        t = umulhi(lo * pinv, p)
        return np.where(hi < t, hi - t + p, hi - t)


def mont_mul(a, b, p, pinv):
    """a b R^-1 mod p: needs a b < R p (hi < p), any u64 a against b < p."""
    with np.errstate(over="ignore"):
        return mont_reduce(umulhi(a, b), a * b, p, pinv)


def mulmod(a, b, p, pinv, r2):
    """a b mod p as two Montgomery products, the second against r2 = R^2 mod
    p (mont.cuh's mulmod: the fused entries)."""
    assert (r2 < p).all()
    return mont_mul(mont_mul(a, b, p, pinv), r2, p, pinv)


def bits(p):
    """k: each prime's bit length (64 - __clzll(p))."""
    return np.array([int(v).bit_length() for v in np.ravel(p)], dtype=U).reshape(np.shape(p))


def barrett_mulmod(a, b, p, mu):
    """modmath.cu barrett_mulmod: a b mod p with one reduction, for residues
    a, b < p < 2^62: q = floor(floor(ab / 2^(k-1)) mu / 2^64) is at most 2
    below floor(ab / p), so ab - q p < 3p."""
    assert (a < p).all() and (b < p).all(), "barrett_mulmod needs a, b < p"
    k = bits(p)
    with np.errstate(over="ignore"):
        lo, hi = a * b, umulhi(a, b)
        x = (lo >> (k - U(1))) | (hi << (U(65) - k))
        r = lo - umulhi(x, mu) * p
        assert (r < U(3) * p).all(), "the Barrett remainder must lie below 3p"
        r = np.where(r >= p, r - p, r)
        return np.where(r >= p, r - p, r)


def addmod(a, b, p):
    assert (a < p).all() and (b < p).all() and (p < U(1 << 63)).all(), "addmod needs a, b < p < 2^63"
    with np.errstate(over="ignore"):
        s = a + b
        return np.where(s >= p, s - p, s)


def submod(a, b, p):
    assert (a < p).all() and (b < p).all(), "submod needs a, b < p"
    with np.errstate(over="ignore"):
        return np.where(a < b, a - b + p, a - b)


def barrett_mu(p):
    """mu = floor(2^(k+63) / p), k each prime's bit length (2 <= k <= 62)."""
    k = bits(p)
    assert ((k >= 2) & (k <= 62)).all(), "the Barrett form needs 2 <= k <= 62"
    return np.array([(1 << (int(q).bit_length() + 63)) // int(q) for q in np.ravel(p)],
                    dtype=U).reshape(np.shape(p))


def ew_op(op, u, v, p, pinv, mu):
    """mm_ew_kernel's arithmetic: mulmod by one Barrett reduction against mu,
    mont_mul against pinv."""
    if op == OP_MONT_MUL:
        return mont_mul(u, v, p, pinv)
    if op == OP_MULMOD:
        return barrett_mulmod(u, v, p, mu)
    return addmod(u, v, p) if op == OP_ADDMOD else submod(u, v, p)


# ---------------------------------------------------------------------------
# mm_ew_kernel's work split
# ---------------------------------------------------------------------------

def threads_of(m: int) -> int:
    return 256 if m >= 256 else -(-m // 32) * 32


def ew_launch(A: int, dim: int, n: int, grid_z: int = GRID_Z) -> dict:
    """The launch of gpqhe_modmath_ew: threads a block, the grid, and each
    live thread's first word k0 (a block takes EW_WORDS T words of a row, a
    thread pair j at k0 + 2 j T) with whether all its words lie below n."""
    T = threads_of(-(-n // EW_WORDS))
    gx = -(-n // (T * EW_WORDS))
    bx, t = np.meshgrid(np.arange(gx), np.arange(T), indexing="ij")
    k0 = (bx * EW_PAIRS * 2 * T + 2 * t).reshape(-1)
    k0 = k0[k0 < n]                                  # the others return at once
    whole = k0 + (EW_PAIRS - 1) * 2 * T + 1 < n
    return {"threads": T, "grid": (gx, min(dim, GRID_Z), min(A, grid_z)), "k0": k0,
            "whole": whole, "step": 2 * T}


def thread_words(k0, step):
    """[threads, EW_WORDS]: the words of each thread, pair by pair."""
    i = np.arange(EW_WORDS)
    return k0[:, None] + (i >> 1)[None, :] * step + (i & 1)[None, :]


class ModelLib:
    """The library's entries, run by the model; each ew call appends what it
    did to `plans`."""

    def __init__(self, grid_z: int = GRID_Z):
        self.grid_z = grid_z
        self.plans = []

    def _rows(self, A, dim, gy, gz):
        """The (a, d) rows in the order the blocks take them: blockIdx.y and
        blockIdx.z each walk their axis by the grid's extent."""
        rows = [(a, d) for by in range(gy) for d in range(by, dim, gy)
                for bz in range(gz) for a in range(bz, A, gz)]
        return np.array(rows, dtype=np.int64).reshape(-1, 2)

    def gpqhe_modmath_ew(self, op, A, dim, n, out, x, xa, xd, xk, y, ya, yd, yk, p, pd,
                         pinv, vd, mu, md, stream):
        if op not in range(4):
            return 1                                # cudaErrorInvalidValue
        assert n < 1 << 30
        L = ew_launch(A, dim, n, self.grid_z)
        gx, gy, gz = L["grid"]
        rows = self._rows(A, dim, gy, gz)
        a, d = rows[:, 0], rows[:, 1]
        P = _strided(p, (dim,), (pd,)).astype(U)[d][:, None]
        V = (_strided(pinv, (dim,), (vd,)).astype(U)[d][:, None] if op == OP_MONT_MUL
             else None)
        MU = None
        if op == OP_MULMOD:
            MU = _strided(mu, (dim,), (md,)).astype(U)[d][:, None]
            assert np.array_equal(MU, barrett_mu(P)), "mu is not floor(2^(k+63) / p)"
        k0, whole, step = L["k0"], L["whole"], L["step"]
        kw = thread_words(k0, step)                                      # [threads, W]
        paths = {}

        def load(ptr, sa, sd, sk, name):
            """[rows, threads, W] words as ew_load reads them, and its path
            for each (row, thread)."""
            base = ptr + 8 * (a * sa + d * sd)                           # the row's word 0
            vec = (sk == 1) & whole[None, :] & ((base % 16) == 0)[:, None]
            const = np.broadcast_to(np.array(sk == 0), vec.shape)
            word = ~vec & ~const
            M = _strided(ptr, (A, dim, n), (sa, sd, sk))
            w = M[a[:, None, None], d[:, None, None], np.minimum(kw, n - 1)[None]].copy()
            # the word path leaves the words past n 0; the pair path reads only
            # aligned pairs of words below n
            w[word[:, :, None] & (kw >= n)[None]] = 0
            assert not (vec[:, :, None] & (kw >= n)[None]).any()
            pair_addr = base[:, None, None] + 8 * kw[None, :, 0::2]
            assert (pair_addr[vec] % 16 == 0).all(), "a 16-byte load off alignment"
            if sk == 0:
                w[...] = M[a, d, 0][:, None, None]
            paths[name] = {"pair": int(vec.sum()), "const": int(const.sum()),
                           "word": int(word.sum())}
            return w
        u = load(x, xa, xd, xk, "x")
        v = load(y, ya, yd, yk, "y")
        with np.errstate(over="ignore"):
            r = ew_op(op, u.reshape(len(rows), -1), v.reshape(len(rows), -1), P, V, MU)
        r = r.reshape(u.shape)
        O = _mem(out, A * dim * n).reshape(A, dim, n)
        seen = np.zeros((A, dim, n), dtype=np.int64)
        orow = out + 8 * ((a * dim + d) * n)
        vec_out = whole[None, :] & ((orow % 16) == 0)[:, None]
        live = np.broadcast_to(kw[None] < n, r.shape)
        ii = np.broadcast_to(a[:, None, None], r.shape)[live]
        jj = np.broadcast_to(d[:, None, None], r.shape)[live]
        kk = np.broadcast_to(kw[None], r.shape)[live]
        O[ii, jj, kk] = r[live]
        np.add.at(seen, (ii, jj, kk), 1)
        assert (seen == 1).all(), "an output word written other than once"
        self.plans.append({"entry": "ew", "op": op, "threads": L["threads"], "grid": L["grid"],
                           "paths": paths, "store_pair": int(vec_out.sum()),
                           "store_word": int((~vec_out).sum()),
                           "tail": bool((~whole).any()), "z_loop": A > gz, "y_loop": dim > gy})
        return 0

    # the fused entries, word by word (their work split: one thread a word,
    # the grid over n, the primes and A)

    @staticmethod
    def _consts(dim, p, pd, pinv, vd, r2, rd):
        return tuple(_strided(c, (dim,), (s,)).astype(U)[:, None] for c, s in
                     ((p, pd), (pinv, vd), (r2, rd)))

    def gpqhe_modmath_cross(self, A, dim, n, out, x, xm, xa, xd, xk, p, pd, pinv, vd, r2, rd,
                            stream):
        X = _strided(x, (4, A, dim, n), (xm, xa, xd, xk))
        P, V, R = self._consts(dim, p, pd, pinv, vd, r2, rd)
        x0, x1, y0, y1 = X
        O = _mem(out, 3 * A * dim * n).reshape(3, A, dim, n)
        O[0] = mulmod(x0, y0, P, V, R)
        O[1] = addmod(mulmod(x0, y1, P, V, R), mulmod(x1, y0, P, V, R), P)
        O[2] = mulmod(x1, y1, P, V, R)
        return 0

    def gpqhe_modmath_keyprod(self, A, dim, n, out, x, xa, xd, xk, e0, ea, ed, ek, e1, fa, fd,
                              fk, p, pd, pinv, vd, r2, rd, stream):
        X = _strided(x, (A, dim, n), (xa, xd, xk))
        P, V, R = self._consts(dim, p, pd, pinv, vd, r2, rd)
        O = _mem(out, 2 * A * dim * n).reshape(2, A, dim, n)
        for h, (e, sa, sd, sk) in enumerate(((e0, ea, ed, ek), (e1, fa, fd, fk))):
            O[h] = mulmod(X, _strided(e, (A, dim, n), (sa, sd, sk)), P, V, R)
        return 0

    def gpqhe_modmath_sum(self, mode, M, A, dim, n, out, x, xm, xa, xd, xk, y, ym, ya, yd, yk,
                          w0, vm, va, vd0, vk, w1, um, ua, ud, uk, p, pd, pinv, qd, r2, rd,
                          stream):
        X = _strided(x, (M, A, dim, n), (xm, xa, xd, xk))
        P = _strided(p, (dim,), (pd,)).astype(U)[:, None]
        nout = 2 if mode == SUM_PRODUCTS_TIMES else 1
        O = _mem(out, nout * A * dim * n).reshape(nout, A, dim, n)
        if mode == SUM_PLAIN:
            terms = [X]
        else:
            _, V, R = self._consts(dim, p, pd, pinv, qd, r2, rd)
            t = mulmod(X, _strided(y, (M, A, dim, n), (ym, ya, yd, yk)), P, V, R)
            terms = [t] if mode == SUM_PRODUCTS else [
                mulmod(t, _strided(w, (M, A, dim, n), st), P, V, R)
                for w, st in ((w0, (vm, va, vd0, vk)), (w1, (um, ua, ud, uk)))]
        for h, term in enumerate(terms):
            s = np.zeros((A, dim, n), dtype=U)
            for m in range(M):
                s = addmod(s, term[m], P)
            O[h] = s
        return 0
