"""Big-integer arithmetic on u32-limb tensors.

Port of gpqhe_tpu/ops/limbs.py.  Polynomials are fixed-width little-endian
limb tensors [..., K] holding nonnegative representatives mod 2**(32K);
signed intermediates use two's complement in that width.  torch has no
unsigned arithmetic, so each u32 limb is stored in an int64 tensor with a
value in [0, 2^32): sums of two limbs, borrows and 16-bit digit sums stay
positive and need no u64 emulation.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _shift_last(c):
    """Shift one position toward higher limbs (c_i lands on limb i+1)."""
    return torch.nn.functional.pad(c[..., :-1], (1, 0))


def _prefix(g, p):
    """Kogge-Stone prefix over the last axis: G_i = carry out of positions
    [0..i] given generate g and propagate p flags (the inclusive
    associative scan of (g, p) under (gl, pl) o (gr, pr) = (gr | pr & gl,
    pl & pr)), in ceil(log2 K) shifted combine steps."""
    k = g.shape[-1]
    d = 1
    while d < k:
        gs = torch.nn.functional.pad(g[..., :-d], (d, 0))
        ps = torch.nn.functional.pad(p[..., :-d], (d, 0))
        g = g | (p & gs)
        p = p & ps
        d *= 2
    return g


def add(a, b):
    """(a + b) mod 2^(32K), log-depth carry-lookahead over the limb axis."""
    s = a + b
    low = s & _M32
    g = (s >> 32) != 0
    p = low == _M32
    carry_in = _shift_last(_prefix(g, p)).to(torch.int64)
    return (low + carry_in) & _M32


def add_scalar_bit(a, bit):
    """a + bit (bit in {0,1} per row), mod 2^(32K); log-depth carry."""
    s0 = a[..., 0] + bit.to(torch.int64)
    low = torch.cat([(s0 & _M32)[..., None], a[..., 1:]], dim=-1)
    g = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    g[..., 0] = (s0 >> 32) != 0
    p = low == _M32
    carry_in = _shift_last(_prefix(g, p & ~g)).to(torch.int64)
    return (low + carry_in) & _M32


def sub(a, b):
    """(a - b) mod 2^(32K), log-depth borrow-lookahead: limb i generates a
    borrow when a_i < b_i and propagates an incoming one when a_i == b_i."""
    borrow_in = _shift_last(_prefix(a < b, a == b)).to(torch.int64)
    return (a - b - borrow_in) & _M32


def neg(a):
    """-a mod 2^(32K)."""
    return add_scalar_bit(a ^ _M32, torch.ones(a.shape[:-1], dtype=torch.int64,
                                               device=a.device))


def select(mask, a, b):
    """Per-row select: mask ? a : b (mask shape = row shape)."""
    return torch.where(mask[..., None], a, b)


def geq_const(a, c_limbs):
    """a >= c (c a [K] limb tensor or a broadcastable limb tensor).

    Per-limb (gt - lt) signs weighted by limb significance and summed; the
    sign of the total is the comparison.  One round is exact for <= 62
    limbs; wider operands fold hierarchically, each round collapsing chunks
    of <= 62 limb signs into one exact chunk sign."""
    c = torch.broadcast_to(c_limbs, a.shape)
    sgn = (a > c).to(torch.int64) - (a < c).to(torch.int64)
    while sgn.shape[-1] > 1:
        m = min(62, sgn.shape[-1])
        pad = (-sgn.shape[-1]) % m
        if pad:  # zero signs at the high end: "equal" padding limbs
            sgn = torch.nn.functional.pad(sgn, (0, pad))
        g = sgn.shape[-1] // m
        w = torch.tensor(np.left_shift(np.int64(1), np.arange(m)),
                         device=a.device)
        score = (sgn.reshape(sgn.shape[:-1] + (g, m)) * w).sum(-1)
        sgn = torch.sign(score)
    return sgn[..., 0] >= 0


def mask_bits(a, nbits: int):
    """Keep the low nbits: a mod 2^nbits (static nbits)."""
    k = a.shape[-1]
    full, rem = divmod(nbits, 32)
    if full >= k:
        return a
    out = torch.zeros_like(a)
    out[..., :full] = a[..., :full]
    if rem:
        out[..., full] = a[..., full] & ((1 << rem) - 1)
    return out


def rshift(a, t: int, k_out: int | None = None):
    """floor(a / 2^t) for nonnegative a (static t), output k_out limbs."""
    k = a.shape[-1]
    if k_out is None:
        k_out = k
    s, r = divmod(t, 32)
    # limbs s .. s+k_out, zero past the top
    ext = resize(a, max(k, s + k_out + 1))
    lo = ext[..., s:s + k_out]
    if r == 0:
        return lo
    hi = ext[..., s + 1:s + k_out + 1]
    return ((lo >> r) | (hi << (32 - r))) & _M32


def rshift_round(a, t: int, k_out: int | None = None):
    """Round-to-nearest division by 2^t, remainder ties (== 2^(t-1)) round DOWN:
    floor(a/2^t) + [a mod 2^t > 2^(t-1)]  (ref: src/types.c:115-128 with m=2^t).
    a must be a nonnegative representative."""
    q = rshift(a, t, k_out)
    if t == 0:
        return q
    # frac > 2^(t-1)  <=>  bit t-1 set AND low t-1 bits nonzero
    hb_limb, hb_bit = divmod(t - 1, 32)
    topbit = (a[..., hb_limb] >> hb_bit) & 1
    low_nonzero = (a[..., :hb_limb] != 0).any(-1)
    if hb_bit > 0:
        low_nonzero = low_nonzero | ((a[..., hb_limb] & ((1 << hb_bit) - 1)) != 0)
    return add_scalar_bit(q, (topbit == 1) & low_nonzero)


def sign_extend(a, k_out: int):
    """Two's-complement widen: replicate the top bit into new limbs."""
    k = a.shape[-1]
    if k_out <= k:
        return a[..., :k_out]
    top = ((a[..., k - 1] >> 31) & 1) * _M32
    ext = top[..., None].expand(a.shape[:-1] + (k_out - k,))
    return torch.cat([a, ext], dim=-1)


def fit_signed(a, mask_to_bits: int, k_out: int):
    """Reduce a two's-complement value mod 2^mask_to_bits and emit k_out limbs.

    Widening past the source width sign-extends first (zero extension
    corrupts negative values); narrowing is plain truncation."""
    src_bits = 32 * a.shape[-1]
    if mask_to_bits >= src_bits and k_out > a.shape[-1]:
        a = sign_extend(a, k_out)
    return resize(mask_bits(a, min(mask_to_bits, 32 * a.shape[-1])), k_out)


def resize(a, k_out: int):
    """Zero-extend or truncate to k_out limbs (value mod 2^(32 k_out))."""
    k = a.shape[-1]
    if k_out == k:
        return a
    if k_out < k:
        return a[..., :k_out]
    return torch.nn.functional.pad(a, (0, k_out - k))


def from_digits16(d, k_out: int):
    """int64[..., D] 16-bit digit sums (each < 2^48) -> [..., k_out] limbs,
    with carry propagation; value taken mod 2^(32 k_out).

    Three parallel split-and-add rounds shrink every digit to <= 2^16
    (bounds 2^48 -> 2^32+2^16 -> 2^17 -> 2^16), then the remaining 0/1
    ripple is resolved with a Kogge-Stone prefix over (generate, propagate)
    flags."""
    want = 2 * k_out
    d = resize(d, want)
    for _ in range(3):
        d = (d & _M16) + _shift_last(d >> 16)
    b = d & _M16
    g = (d >> 16) != 0           # digit == 2^16: generates a carry
    p = b == _M16                # digit == 0xFFFF: propagates a carry
    digits = (b + _shift_last(_prefix(g, p)).to(torch.int64)) & _M16
    return digits[..., 0::2] | (digits[..., 1::2] << 16)


def to_digits16_f64(a):
    """[..., K] limbs -> f64[..., 2K] 16-bit digits (exact in f64)."""
    return torch.stack([a & _M16, a >> 16], dim=-1).reshape(
        a.shape[:-1] + (2 * a.shape[-1],)).to(torch.float64)


def to_f64_centered(a, q_bits: int):
    """Centered value (smod 2^q_bits) of a as f64 (ref: src/types.c:77-106 +
    mpi_smod semantics).  Exact for |value| < 2^53; relative error 2^-53 above."""
    am = mask_bits(a, q_bits)
    hb_limb, hb_bit = divmod(q_bits - 1, 32)
    negmask = ((am[..., hb_limb] >> hb_bit) & 1) == 1
    # magnitude of the negative branch: 2^q_bits - am, re-masked to q_bits
    mag = select(negmask, mask_bits(neg(am), q_bits), am)
    val = torch.zeros(mag.shape[:-1], dtype=torch.float64, device=a.device)
    for i in range(mag.shape[-1] - 1, -1, -1):
        val = val * 4294967296.0 + mag[..., i].to(torch.float64)
    return torch.where(negmask, -val, val)


def toeplitz16(c16: np.ndarray, k_in: int, k_out: int) -> np.ndarray:
    """f64[2 k_in, 2 k_out] band M[u, s] = c16[s - u]: the digit convolution
    of a [2 k_in]-digit operand with the constant c, truncated to 2 k_out
    output digits."""
    c = np.asarray(c16, dtype=np.float64)
    M = np.zeros((2 * k_in, 2 * k_out), dtype=np.float64)
    for u in range(2 * k_in):
        hi = min(2 * k_out - u, c.shape[0])
        if hi > 0:
            M[u, u:u + hi] = c[:hi]
    return M


def mul_const_mod2k(a, c16: np.ndarray, k_out: int):
    """a * c mod 2^(32 k_out), c given as host u16-digit array.

    Exact f64 digit convolution: every product of two 16-bit digits is
    < 2^32, and a column sums at most 2K of them, so each column sum is
    < 2K * 2^32 <= 2^53 for K <= 2^20 limbs: integer-exact in f64.  (The JAX
    package used 8-bit bf16 planes for the TPU's matrix unit; the value is
    the same.)"""
    M = torch.from_numpy(toeplitz16(c16, a.shape[-1], k_out)).to(a.device)
    s16 = torch.matmul(to_digits16_f64(a), M).to(torch.int64)
    return from_digits16(s16, k_out)
