"""K7 (csrc/limbs.cu) and the CRT lift (csrc/rns.cu) on csrc/rowwarp.cuh in
numpy, for the CPU tests of both kernels: each launch's work split as the
kernel makes it (which lane of which warp takes which row and limb: the
word kernel's flattened words with FastDiv, the warp design's lane groups,
the chunks of 32 limbs of a wide row, the rows a block and the last partial
block) and its arithmetic as the kernel runs it (the ballot chains with the
carry from chunk to chunk, the shuffles of the digit carries), on native u64
words, vectorised over warps.  The operands are read through the strides
that ops/limbs_cuda.py gives the kernel, from their storage.  The constants
below mirror the .cuh and rns.cu (held equal by
tests/test_torch_elementwise_kernels.py).
"""

import math

import numpy as np
import torch

from gpqhe_tpu_torch.ops import limbs_cuda as lc

U = np.uint64
M32 = U(0xFFFFFFFF)
ROWWARP_THREADS = 128         # rowwarp.cuh: threads of a block
WARP_GROUPS = 4           # rowwarp.cuh: rows a lane takes
MAX_CHUNKS = 4            # rns.cu: the lift's chunks of 32 limbs a row
LANE = np.arange(32, dtype=U)


def lanes_a_group(L: int) -> int:
    """W: the lanes of a row group for rows of L limbs (one spare below 32)."""
    return L + 1 if L < 32 else 32


def rows_a_block(L: int, rows_a_lane: int = WARP_GROUPS) -> int:
    """rowwarp.cuh rows_a_block: the rows a block takes."""
    return ROWWARP_THREADS // 32 * rows_a_lane * (32 // lanes_a_group(L))


def chain_limbs(op: str, k: int, k_out: int) -> int:
    """L: the limbs a row of a chain walks (limbs.cu: the output's for
    from_digits16 and a widening shift)."""
    return k_out if op == "from_digits16" or k_out > k else k


def lift_chunks(k_out: int) -> int:
    """NCH: the lift's chunks of 32 limbs a row (gpqhe_rns_lift)."""
    return 1 if k_out <= 32 else 2 if k_out <= 64 else 4


def lift_rows_a_lane(nch: int) -> int:
    """RL: the lift's rows a lane at NCH chunks."""
    return WARP_GROUPS // nch


# ---------------------------------------------------------------------------
# operands, FastDiv
# ---------------------------------------------------------------------------

def fastdiv(d: int):
    """rowwarp.cuh FastDiv::of(d): the divider n -> (umulhi(n, m) + n) >> s."""
    s = 0
    while s < 32 and (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    return lambda n: ((n.astype(U) * U(m)) >> U(32)) + n.astype(U) >> U(s)


class Rows:
    """limbs.cu Rows: a [R1, R2, K] operand by storage, offset and strides
    (s1 normalised to s2 R2 where R1 is 1, as gpqhe_limbs does)."""

    def __init__(self, x: torch.Tensor, shape3: tuple):
        args, v = lc._rows(x, shape3)
        _, s1, s2, sk = args
        self.R1, self.R2 = math.prod(shape3[:-2]), shape3[-2]
        self.s1 = s2 * self.R2 if self.R1 == 1 else s1
        self.s2, self.sk = s2, sk
        n = v.untyped_storage().nbytes() // v.element_size()
        arr = v.as_strided((n,), (1,), 0).numpy()
        self.words = (arr.astype(np.int64).view(U) if v.dtype == torch.float64
                      else arr.astype(U) if v.dtype == torch.bool else arr.view(U))
        self.base = v.storage_offset()
        self.div = fastdiv(self.R2)
        # limbs.cu pairs_ok: 16-byte accesses to two limbs of a row
        self.pairs_ok = (self.sk == 1 and self.s1 % 2 == 0 and self.s2 % 2 == 0
                         and v.data_ptr() % 16 == 0)

    def row_off(self, row):
        row = row.astype(U)
        if self.s1 == self.s2 * self.R2:
            return row.astype(np.int64) * self.s2
        r1 = self.div(row)
        return r1.astype(np.int64) * self.s1 + (row - r1 * U(self.R2)).astype(np.int64) * self.s2

    def at(self, row, i):
        return self.words[self.base + self.row_off(row) + np.asarray(i, dtype=np.int64) * self.sk]

    def load(self, on, row, i):
        """`on ? at(row, i) : 0`, lanes that are off reading nothing."""
        return np.where(on, self.at(np.where(on, row, 0), np.where(on, i, 0)), U(0))


def _ballot(b):
    """__ballot_sync over each warp: b bool [warps, 32] -> u64 masks [warps, 1]."""
    return (b.astype(U) << LANE).sum(axis=1, dtype=U)[:, None]


def _lane31(x):
    """__shfl_sync(x, 31), to every lane."""
    return np.broadcast_to(x[:, 31:], x.shape).copy()


# ---------------------------------------------------------------------------
# the warp design (LaneGroups and its ballot chains)
# ---------------------------------------------------------------------------

class Lanes:
    """LaneGroups for `nw` warps: lane i of group grp, W lanes a group."""

    def __init__(self, L: int, nw: int):
        self.W = lanes_a_group(L)
        self.G = 32 // self.W
        lane = np.arange(32)
        self.grp = np.broadcast_to(lane // self.W, (nw, 32))
        self.i = np.broadcast_to(lane - (lane // self.W) * self.W, (nw, 32))
        self.base = (self.grp * self.W).astype(U)

    def mask(self):
        m = M32 if self.W >= 32 else U((1 << self.W) - 1)
        return (m << self.base) & M32


def lane_chain(lg, gen, prop, c):
    """The carries into each lane; returns (carries, c out of lane 31)."""
    X, Y = _ballot(gen | prop), _ballot(gen)
    C = _ballot((lg.i == 0) & (c != 0))
    s = X + Y + C
    return ((s ^ X ^ Y) >> LANE) & U(1), np.broadcast_to(s >> U(32), c.shape).copy()


def lane_geq(lg, limb, x, c, ge):
    """The chunk's verdict where it has a difference, else ge."""
    ne = _ballot(limb & (x != c)) & lg.mask()
    gt = _ballot(limb & (x > c))
    top = np.where(ne > 0, np.floor(np.log2(np.maximum(ne, U(1)).astype(np.float64))), 0)
    return np.where(ne > 0, ((gt >> top.astype(U)) & U(1)) == 1, ge)


def lane_add(lg, limb, x, y, c):
    s = x + y
    k, c = lane_chain(lg, limb & ((s >> U(32)) != 0), limb & ((s & M32) == M32), c)
    return (s + k) & M32, c


def lane_sub(lg, limb, x, y, c):
    k, c = lane_chain(lg, limb & (x < y), limb & (x == y), c)
    return (x - y - k) & M32, c


def lane_up(lg, lo, hi, h, chunked):
    up = np.concatenate([hi[:, :1], hi[:, :-1]], axis=1)      # __shfl_up_sync by 1
    v = lo + np.where(lg.i > 0, up, h)
    return v & M32, v >> U(32), _lane31(hi) if chunked else h


def lane_digits(lg, limb, d0, d1, dc, chunked):
    """dc = [h1, h2, c], the carries into the chunk, replaced by those out
    (h1, h2 only where the row goes on: chunked)."""
    t = (d0 & M32) + ((d1 & U(0xFFFF)) << U(16))
    lo, hi = t & M32, (t >> U(32)) + (d0 >> U(32)) + (d1 >> U(16))
    lo, hi, dc[0] = lane_up(lg, lo, hi, dc[0], chunked)
    lo, hi, dc[1] = lane_up(lg, lo, hi, dc[1], chunked)
    k, dc[2] = lane_chain(lg, limb & (hi != 0), limb & (lo == M32), dc[2])
    return (lo + k) & M32


def _warp_rows(L, rows, rows_a_lane=WARP_GROUPS):
    """The lane groups, and per u the rows of every lane and whether its
    group is live."""
    per_warp = rows_a_lane * (32 // lanes_a_group(L))
    nw = -(-rows // per_warp)
    lg = Lanes(L, nw)
    warp = np.arange(nw)[:, None]
    out = []
    for u in range(rows_a_lane):
        row = warp * per_warp + u * lg.G + lg.grp
        out.append((row, (lg.grp < lg.G) & (row < rows)))
    return lg, out


def _shfl(x, src):
    """__shfl_sync(x, src & 31) per lane."""
    return np.take_along_axis(x, (np.asarray(src) & 31).astype(np.int64), axis=1)


def _limbs_rows(op, rows, K, k_out, t, nbits, a, b, bit, out):
    """limbs_row_kernel: the chains, chunk by chunk (geq_const from the top
    chunk down, until every row of the warp has met a difference)."""
    L = chain_limbs(op, K, k_out)
    nch = -(-L // 32)
    lg, groups = _warp_rows(L, rows)
    zeros = np.zeros(lg.i.shape, dtype=U)
    b_row = op in ("add", "sub", "geq_const") and b.s1 == 0 and b.s2 == 0
    s, r = divmod(t, 32)
    sb, sr = s // 32 * 32, s % 32
    hl, hb = divmod(t - 1, 32) if t > 0 else (0, 0)
    nlow = min(hl, K) if t > 0 else 0
    full, rem = divmod(nbits, 32)
    shift = op in ("rshift_round", "rshift_round_mask")
    c = [zeros.copy() for _ in groups]
    nxt = [zeros.copy() for _ in groups]
    ge = [np.ones(lg.i.shape, dtype=bool) for _ in groups]
    done = [~live for _, live in groups]
    dc = [[zeros.copy(), zeros.copy(), zeros.copy()] for _ in groups]
    with np.errstate(over="ignore"):
        if op == "add_scalar_bit":
            for u, (row, live) in enumerate(groups):
                c[u] = (live & (bit.at(np.where(row < rows, row, 0), 0) != 0)).astype(U)
        for n in range(nch):
            c0 = 32 * (nch - 1 - n if op == "geq_const" else n)
            li = c0 + lg.i
            yc = b.load((lg.grp < lg.G) & (li < K), np.zeros_like(li), li) if b_row else None
            x, y = [None] * len(groups), [None] * len(groups)
            for u, (row, live) in enumerate(groups):
                inn = live & (li < K)
                if op == "from_digits16":
                    x[u] = a.load(live & (li < k_out) & (2 * li < K), row, 2 * li)
                    y[u] = a.load(live & (li < k_out) & (2 * li + 1 < K), row, 2 * li + 1)
                elif shift:
                    j = sb + li
                    x[u] = nxt[u] if c0 else a.load(live & (j < K), row, j)
                    if nch > 1:
                        nxt[u] = a.load(live & (j + 32 < K), row, j + 32)
                else:
                    x[u] = a.load(inn, row, li)
                    if op in ("add", "sub", "geq_const"):
                        y[u] = yc if b_row else b.load(inn, row, li)
            if shift and c0 == 0 and t > 0:
                for u, (row, live) in enumerate(groups):
                    # limb hl and the limbs below it: in the first chunk where sb
                    # is 0, else read 32 at a time
                    h = _shfl(x[u], lg.base.astype(np.int64) + hl)
                    nz = _ballot((sb == 0) & (lg.i < nlow) & (x[u] != 0)) & lg.mask()
                    if sb:
                        h = a.load(live & (hl < K), row, hl)
                    elif hl >= K:
                        h = zeros.copy()
                    for c1 in range(32 if sb == 0 else 0, nlow, 32):
                        nz |= _ballot(a.load(live & (c1 + lg.i < nlow), row, c1 + lg.i)
                                      != 0) & lg.mask()
                    low = ((h & U((1 << hb) - 1)) != 0) if hb else np.zeros(h.shape, bool)
                    c[u] = (live & (((h >> U(hb)) & U(1)) == 1) & (low | (nz != 0))).astype(U)
            for u, (row, live) in enumerate(groups):
                inn = live & (li < K)
                if op == "geq_const":
                    ne = _ballot(inn & (x[u] != y[u])) & lg.mask()
                    ge_new = lane_geq(lg, inn, x[u], y[u], ge[u])
                    ge[u] = np.where(done[u], ge[u], ge_new)
                    done[u] = done[u] | (ne != 0)
                    continue
                if op == "add":
                    w, c[u] = lane_add(lg, inn, x[u], y[u], c[u])
                elif op == "sub":
                    w, c[u] = lane_sub(lg, inn, x[u], y[u], c[u])
                elif op == "neg":
                    w, c[u] = lane_sub(lg, inn, zeros, x[u], c[u])
                elif op == "add_scalar_bit":
                    k, c[u] = lane_chain(lg, np.zeros_like(inn), inn & (x[u] == M32), c[u])
                    w = (x[u] + k) & M32
                elif op == "from_digits16":
                    w = lane_digits(lg, live & (li < k_out), x[u], y[u], dc[u], nch > 1)
                else:
                    def limb(j):
                        lo = _shfl(x[u], lg.base.astype(np.int64) + j)
                        hi = _shfl(nxt[u], j)
                        return np.where(sb + c0 + j < K, np.where(j < 32, lo, hi), U(0))
                    q0, q1 = limb(lg.i + sr), limb(lg.i + sr + 1)
                    q = (((q0 >> U(r)) | (q1 << U(32 - r))) & M32) if r else q0
                    k, c[u] = lane_chain(lg, np.zeros_like(live), live & (li < k_out) & (q == M32),
                                         c[u])
                    w = (q + k) & M32
                    if op == "rshift_round_mask":
                        w = np.where(li >= K, U(0), np.where(
                            li < full, w, np.where((li == full) & (rem > 0),
                                                   w & U((1 << rem) - 1), U(0))))
                sel = live & (li < k_out)
                out[(row * k_out + li)[sel]] = w[sel]
            if op == "geq_const" and all(d.all() for d in done):
                break
        if op == "geq_const":
            for u, (row, live) in enumerate(groups):
                sel = live & (lg.i == 0)
                out[row[sel]] = ge[u][sel]


def _limbs_word(op, rows, K, nbits, a, b, bit, out):
    """The word kernel: a thread a word, or a pair of a row's neighbouring
    limbs where every limb operand allows 16-byte accesses; returns the
    words a thread."""
    V = 2 if K % 2 == 0 and a.pairs_ok and (op == "mask_bits" or b.pairs_ok) else 1
    total = rows * K // V
    full, rem = divmod(nbits, 32)
    div = fastdiv(max(K // V, 1))
    seen = np.zeros(total, dtype=int)
    for blk in range(-(-total // ROWWARP_THREADS)):
        e = blk * ROWWARP_THREADS + np.arange(ROWWARP_THREADS)
        e = e[e < total]
        seen[e] += 1
        row = div(e.astype(U))
        assert np.array_equal(row, e // (K // V))
        i0 = (e - row.astype(np.int64) * (K // V)) * V
        if V == 2:
            assert ((a.row_off(row) + i0) % 2 == 0).all()
        for h in range(V):
            i = i0 + h
            x = a.at(row, i)
            if op == "mask_bits":
                v = np.where(i < full, x, np.where((i == full) & (rem > 0),
                                                   x & U((1 << rem) - 1), U(0)))
            else:
                v = np.where(bit.at(row, 0) != 0, x, b.at(row, i))
            out[e * V + h] = v
    assert (seen == 1).all()
    return V


def run_limbs(op, out_shape, k, a, b=None, bit=None, k_out=0, t=0, nbits=0):
    """One gpqhe_limbs launch as the wrapper (ops/limbs_cuda.launch) makes it
    and the kernel runs it; returns (output as numpy, how it ran: the word
    kernel's words a thread, or the chain's lanes a group and chunks)."""
    rows = tuple(out_shape[:-1]) if op != "geq_const" else tuple(out_shape)
    shape3 = (1,) * max(0, 1 - len(rows)) + rows + (k,)
    A = Rows(a, shape3)
    B = Rows(b, shape3) if b is not None else None
    bt = Rows(bit[..., None], shape3[:-1] + (1,)) if bit is not None else None
    k_out = k_out or k
    nrows = math.prod(shape3[:-1])
    if op == "geq_const":
        out = np.zeros(nrows, dtype=bool)
    else:
        out = np.full(nrows * k_out, U(0xBAD), dtype=U)
    if op in ("mask_bits", "select"):
        plan = {"design": "word", "words_a_thread": _limbs_word(op, nrows, k, nbits, A, B, bt, out)}
    else:
        L = chain_limbs(op, k, k_out)
        plan = {"design": "warp", "lanes": lanes_a_group(L), "chunks": -(-L // 32)}
        _limbs_rows(op, nrows, k, k_out, t, nbits, A, B, bt, out)
    return out.reshape(out_shape), plan


# ---------------------------------------------------------------------------
# the lift
# ---------------------------------------------------------------------------

def run_lift(sd, af, plan, center, k_out):
    """One gpqhe_rns_lift launch (rns_lift_kernel<T, NCH>): digit sums sd
    [R, kd] (f64 or int64), af [R]; returns (limbs [R, k_out or ks] as
    numpy, how it ran)."""
    kd = sd.shape[-1]
    exact = k_out is None
    kout = plan.ks if exact else k_out
    assert 1 <= kout <= 32 * MAX_CHUNKS
    kuse = min(kd, 2 * kout)
    R = af.numel()
    s = sd.reshape(R, kd)
    s = (s.numpy().astype(np.int64) if s.dtype == torch.float64 else s.numpy()).view(U)
    a = af.reshape(R).numpy()
    negP = plan.negP16.numpy().view(U)
    Pt, Pht, Mt = (x.numpy().view(U) for x in (plan.P_limbs, plan.Phalf_limbs,
                                              plan.MminusP_limbs))
    nch = lift_chunks(kout)
    lg, groups = _warp_rows(kout, R, lift_rows_a_lane(nch))
    out = np.full(R * kout, U(0xBAD), dtype=U)

    def const(tab, on, i):
        return np.where(on, tab[np.where(on, i, 0)], U(0))
    lim_lane, n0, n1, P, Ph, MmP = [], [], [], [], [], []
    for ch in range(nch):
        li = 32 * ch + lg.i
        on = (lg.grp < lg.G) & (li < kout)
        lim_lane.append(on)
        n0.append(const(negP, on & (2 * li < kuse), 2 * li))
        n1.append(const(negP, on & (2 * li + 1 < kuse), 2 * li + 1))
        P.append(const(Pt, on, li))
        Ph.append(const(Pht, on & exact, li))
        MmP.append(const(Mt, on & exact, li))
    zeros = np.zeros(lg.i.shape, dtype=U)
    with np.errstate(over="ignore"):
        for row, live in groups:
            r = np.where(live, row, 0)
            av = np.where(live, a[r], 0.0)
            alpha = np.minimum(np.maximum(np.floor(av), 0.0), float(plan.dim))
            ai = alpha.astype(np.int64).view(U)
            limb, x = [], []
            dc = [zeros.copy(), zeros.copy(), zeros.copy()]
            for ch in range(nch):
                li = 32 * ch + lg.i
                on = live & lim_lane[ch]
                s0 = np.where(on & (2 * li < kuse), s[r, np.clip(2 * li, 0, kuse - 1)], U(0))
                s1 = np.where(on & (2 * li + 1 < kuse), s[r, np.clip(2 * li + 1, 0, kuse - 1)],
                              U(0))
                limb.append(lim_lane[ch] & (row < R))
                x.append(lane_digits(lg, limb[ch], s0 + ai * n0[ch], s1 + ai * n1[ch], dc,
                                     nch > 1))

            def compare(y):
                ge, done = np.ones(lg.i.shape, dtype=bool), np.zeros(lg.i.shape, dtype=bool)
                for ch in reversed(range(nch)):
                    ne = _ballot(limb[ch] & (x[ch] != y[ch])) & lg.mask()
                    ge = np.where(done, ge, lane_geq(lg, limb[ch], x[ch], y[ch], ge))
                    done = done | (ne != 0)
                return ge

            def correct(on, add):
                carry = zeros.copy()
                for ch in range(nch):
                    y, carry = (lane_add if add else lane_sub)(lg, limb[ch], x[ch], P[ch], carry)
                    x[ch] = np.where(on, y, x[ch])
            if exact:
                correct(compare(MmP), True)
                correct(compare(P), False)
                if center:
                    correct(compare(Ph), False)
            else:
                correct(av - alpha > 0.5, False)
            for ch in range(nch):
                sel = limb[ch]
                out[(row * kout + 32 * ch + lg.i)[sel]] = x[ch][sel]
    return out.reshape(tuple(af.shape) + (kout,)), {"design": "warp", "lanes": lg.W,
                                                     "chunks": nch}
