"""Modular arithmetic on u64 words held in int64 tensors.

Port of gpqhe_tpu/ops/modmath.py (Montgomery with R = 2**64,
ref: src/reduce.c:36-66).  torch has no unsigned 64-bit arithmetic, so every
u64 word is stored as the int64 with the same bit pattern:

  - `*` and `+` wrap mod 2^64 on int64 exactly as on u64;
  - a right shift of a full 64-bit word is made logical with a mask,
    `(x >> k) & (2^(64-k) - 1)`;
  - compares are signed, so they are used only where both sides are known
    to be < 2^63 (residues < 4p < 2^62 and Montgomery high halves < p).

Host tables holding values >= 2^63 (pinv_mont, Shoup companions) reach torch
through `np.ndarray.view(np.int64)`, never by value.

Dispatch: each public operation (mont_mul, to_mont, mulmod, addmod, submod,
summod, and the fused cross_terms, key_products and mulmod_sum) runs its
plain torch version (plain_*) on a CPU tensor and the CUDA kernel of
ops/modmath_cuda.py on a CUDA tensor, which raises where it cannot run:
there is no fallback.  The plain versions call only plain versions, so the
NTT twin (ops/ntt.py) and the kernels' yardsticks stay pure torch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import modmath_cuda

_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def u64_to_torch(a, device=None) -> torch.Tensor:
    """Host u64 array -> int64 tensor with the same bit patterns."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def torch_to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> host u64 array with the same bit patterns."""
    return t.detach().cpu().numpy().view(np.uint64)


def mulhilo64(a, b):
    """(hi, lo) of the full 128-bit product of u64 words a and b."""
    al = a & _M32
    ah = (a >> 32) & _M32
    bl = b & _M32
    bh = (b >> 32) & _M32
    ll = al * bl                      # < 2^64: wraps into the sign bit
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    cross = ((ll >> 32) & _M32) + (lh & _M32) + (hl & _M32)
    hi = hh + ((lh >> 32) & _M32) + ((hl >> 32) & _M32) + (cross >> 32)
    lo = (cross << 32) | (ll & _M32)
    return hi, lo


def mulhi64(a, b):
    return mulhilo64(a, b)[0]


def mont_reduce(hi, lo, p, pinv):
    """hi_lo * R^-1 mod p (ref: src/reduce.c:59-66).  Requires hi < p, so the
    signed compare below sees two values < p < 2^62.  Output in [0, p)."""
    u = lo * pinv                     # full 64-bit word, wraps
    t = mulhi64(u, p)
    r = hi - t
    return torch.where(hi < t, r + p, r)


def plain_mont_mul(a, b, p, pinv):
    """a * b * R^-1 mod p.  Requires a*b < R*p (e.g. any u64 a and b < p)."""
    hi, lo = mulhilo64(a, b)
    return mont_reduce(hi, lo, p, pinv)


def plain_mulmod(a, b, p, pinv, r2):
    """Exact a*b mod p via two Montgomery multiplies (r2 = R^2 mod p)."""
    return plain_mont_mul(plain_mont_mul(a, b, p, pinv), r2, p, pinv)


def plain_to_mont(a, p, pinv, r2):
    """a -> a*R mod p."""
    return plain_mont_mul(a, r2, p, pinv)


def _ult(a, b):
    """a < b for full u64 words held in int64: flipping the sign bit maps the
    unsigned order onto the signed one."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def barrett_inv(q: int) -> int:
    """Host: 2^(2*nbits(q)) / q (ref: src/reduce.c:75-78)."""
    return (1 << (2 * q.bit_length())) // q


def barrett_reduce(hi, lo, q, qinv, qbits: int):
    """(hi,lo) 128-bit value mod q via Barrett (ref: src/reduce.c:88-106).

    qinv = floor(2^(2*qbits)/q); requires 2*qbits >= 64.  Semantically equal
    to the Montgomery-pair mulmod used on the hot path; kept for parity and
    for callers that have values (not products) to reduce.  All words are
    u64 bit patterns: the 128-bit carry and the final compare are unsigned."""
    t_hi1, _ = mulhilo64(lo, qinv)
    t2_hi, t2_lo = mulhilo64(hi, qinv)
    # t = (lo*qinv >> 64) + hi*qinv  as a 128-bit value
    t_lo = t_hi1 + t2_lo
    t_hi = t2_hi + _ult(t_lo, t2_lo).to(torch.int64)
    shift = 2 * qbits - 64
    if shift > 0:
        t_shifted = ((t_lo >> shift) & ((1 << (64 - shift)) - 1)) | (t_hi << (64 - shift))
    else:
        t_shifted = t_lo
    r = lo - t_shifted * q
    return torch.where(_ult(r, q), r, r - q)


def plain_addmod(a, b, p):
    """(a + b) mod p for a, b in [0, p) with p < 2^62."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def plain_submod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b
    return torch.where(a < b, d + p, d)


def plain_summod(x, p):
    """Sum over the leading axis mod p of residues in [0, p).  Every partial
    stays in [0, p), so any order gives the same words; each addition is a
    two-operand addmod (a plain sum of residues of a 60-bit prime overflows
    the word), taken pairwise: log2 of the axis in depth."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        head = plain_addmod(x[:h], x[h:2 * h], p)
        x = torch.cat([head, x[2 * h:]]) if x.shape[0] % 2 else head
    return x[0]


def plain_cross_terms(x, p, pinv, r2):
    """The product's cross terms: x = (x0, x1, y0, y1) stacked on the leading
    axis -> (x0 y0, x0 y1 + x1 y0, x1 y1) stacked, mod p."""
    x0, x1, y0, y1 = x
    return torch.stack([plain_mulmod(x0, y0, p, pinv, r2),
                        plain_addmod(plain_mulmod(x0, y1, p, pinv, r2),
                                     plain_mulmod(x1, y0, p, pinv, r2), p),
                        plain_mulmod(x1, y1, p, pinv, r2)])


def plain_key_products(x, e0, e1, p, pinv, r2):
    """(x e0, x e1) mod p stacked: a key switch's products with the key halves."""
    return torch.stack([plain_mulmod(x, e0, p, pinv, r2), plain_mulmod(x, e1, p, pinv, r2)])


def plain_mulmod_sum(x, y, p, pinv, r2, ws=()):
    """Sums over the leading axis mod p, stacked: of x y where ws is empty,
    else, with t = x y, of t w for each w of ws."""
    t = plain_mulmod(x, y, p, pinv, r2)
    if not ws:
        return plain_summod(t, p)[None]
    return torch.stack([plain_summod(plain_mulmod(t, w, p, pinv, r2), p) for w in ws])


# ---------------------------------------------------------------------------
# dispatch: plain version on the CPU, the CUDA kernel on a CUDA tensor
# ---------------------------------------------------------------------------

def mont_mul(a, b, p, pinv):
    if a.device.type == "cpu":
        return plain_mont_mul(a, b, p, pinv)
    return modmath_cuda.elementwise("mont_mul", a, b, p, pinv)


def mulmod(a, b, p, pinv, r2):
    if a.device.type == "cpu":
        return plain_mulmod(a, b, p, pinv, r2)
    return modmath_cuda.elementwise("mulmod", a, b, p, pinv, r2)


def to_mont(a, p, pinv, r2):
    if a.device.type == "cpu":
        return plain_to_mont(a, p, pinv, r2)
    return modmath_cuda.elementwise("to_mont", a, r2, p, pinv)


def addmod(a, b, p):
    if a.device.type == "cpu":
        return plain_addmod(a, b, p)
    return modmath_cuda.elementwise("addmod", a, b, p)


def submod(a, b, p):
    if a.device.type == "cpu":
        return plain_submod(a, b, p)
    return modmath_cuda.elementwise("submod", a, b, p)


def summod(x, p):
    if x.device.type == "cpu":
        return plain_summod(x, p)
    return modmath_cuda.sums("summod", x, None, (), p, None, None)[0]


def cross_terms(x, p, pinv, r2):
    if x.device.type == "cpu":
        return plain_cross_terms(x, p, pinv, r2)
    return modmath_cuda.cross_terms(x, p, pinv, r2)


def key_products(x, e0, e1, p, pinv, r2):
    if x.device.type == "cpu":
        return plain_key_products(x, e0, e1, p, pinv, r2)
    return modmath_cuda.key_products(x, e0, e1, p, pinv, r2)


def mulmod_sum(x, y, p, pinv, r2, ws=()):
    if x.device.type == "cpu":
        return plain_mulmod_sum(x, y, p, pinv, r2, ws)
    return modmath_cuda.sums("mulmod_sum", x, y, tuple(ws), p, pinv, r2)
