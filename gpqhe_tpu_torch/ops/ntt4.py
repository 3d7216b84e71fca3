"""Four-step (Bailey) negacyclic NTT with matrix-product stages, in torch.

Port of gpqhe_tpu/ops/ntt4.py, the "matmul" NTT backend.  n = n1 * n2 is
transformed as two modular matrix products (DFT_n1 over the columns, a
twiddle, DFT_n2 over the rows) after a pre-twist by psi^i that makes the
negacyclic transform cyclic.  The output order is the natural four-step
order of the JAX module (out index k1 + n1 k2), not the butterfly NTT's:
the two families must not be mixed on NTT-resident data (keys are
NTT-resident), so an engine takes one.

A stage is out = post * scale * (W @ (pre * X)) mod p on each (poly,
prime) slab, X the slab seen as [K, J] (transposed for the second stage).
Its plain version is JAX's _moddot in three steps:
  split    u64 residues -> the GEMM's f64 operand [dim, K, B P J]: P 16-bit
           digit planes of each word, after the Montgomery multiply that
           precedes the stage (the pre-twist in ntt4, the twiddle in intt4)
           and, for the second stage, the transpose between the stages;
  GEMM     one torch.bmm over the primes: W's planes stacked as
           [dim, P M, K] in the plan, times the operand -> all P^2 digit
           products [dim, P M, B P J] (W is never broadcast over the polys);
  combine  the products -> residues in [0, p): anti-diagonal sums, carry
           assembly into u64 limbs, three Montgomery products against
           c_pow (JAX's _moddot), then the Montgomery multiply that follows
           the stage (the twiddle in ntt4, the untwist * n^-1 and p^-1 in
           intt4).
Every product entry is <= k (2^16 - 1)^2 < 2^40 for k <= 256, every sum
< 2^42, so the f64 values are exact.  P is the digit count of the plan's
widest prime (4 on the 59-bit chain, 2 for primes below 2^32, 1 below
2^16): JAX's further planes are zero, so the results are equal.

On a CUDA tensor a stage is one launch of K8 (ops/ntt4_cuda.py,
csrc/ntt4.cu): the same function on u8 digit planes (P8 of them, the
plan's byte planes of W) on the tensor cores, nothing but the residues in
device memory.  Every step is exact, so both equal JAX's bit for bit.

Dispatch: ntt4/intt4 run the plain versions (plain_*, pure torch) on a CPU
tensor and the kernel on a CUDA tensor; the kernel raises where it cannot
run: there is no fallback.

Plan tables are built in numpy: one power table of psi per prime (length
2n, by doubling over Python-int object arrays), gathered at each table's
exponents, and kept per (prime, n).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import ntt4_cuda
from .modmath import plain_addmod, plain_mont_mul, u64_to_torch

LOGN_MIN, LOGN_MAX = 4, 16       # n1, n2 <= 256: the digit sums stay exact


@dataclass(frozen=True)
class Ntt4Plan:
    """Per-basis constants of the four-step NTT over dim primes (u64 bit
    patterns in int64, the 16-bit digit planes in f64, the byte planes in
    u8, on one device).  The 16-bit planes (the plain version's) are in the
    GEMM's layout: W's plane v is rows v m .. v m + m - 1 of w1dig
    [dim, P n1, n1] (JAX: [dim, 4, n1, n1]); the byte planes (the kernel's)
    are w1u8 [dim, P8, n1, n1], byte v of W in plane v."""
    n1: int
    n2: int
    dim: int
    planes: int               # P: 16-bit digits of the widest prime
    planes8: int              # P8: its bytes, rounded up to 2, 4 or 8
    ps: torch.Tensor          # [dim]
    pinv: torch.Tensor        # [dim]
    # forward
    w1dig: torch.Tensor       # f64[dim, P n1, n1] digit planes of DFT_n1
    w2dig: torch.Tensor       # f64[dim, P n2, n2]
    twid: torch.Tensor        # [dim, n1, n2] Montgomery omega^(k1 i2)
    twist: torch.Tensor       # [dim, n] Montgomery psi^i (pre-twist)
    # inverse
    w1dig_i: torch.Tensor
    w2dig_i: torch.Tensor
    twid_i: torch.Tensor
    twist_i: torch.Tensor     # [dim, n] Montgomery psi^-i n^-1 (post-twist)
    c_pow: torch.Tensor       # [dim, 3]: (2^0, 2^64, 2^128) R mod p
    phatinv: torch.Tensor     # [dim] Montgomery phat^-1 (the scaled inverse)
    # the kernel's byte planes of the four W, and its fold constants
    w1u8: torch.Tensor        # u8[dim, P8, n1, n1]
    w2u8: torch.Tensor        # u8[dim, P8, n2, n2]
    w1u8_i: torch.Tensor
    w2u8_i: torch.Tensor
    c32: torch.Tensor         # [dim, 4]: 2^(32 q) R mod p, q < 4

    def w(self, name: str, kind: str) -> torch.Tensor:
        """W's planes of a stage, name "w1", "w2", "w1_i" or "w2_i", as the
        plain version's 16-bit f64 planes (kind "dig") or the kernel's byte
        planes ("u8")."""
        return getattr(self, name[:2] + kind + name[2:])


def split_logn(logn: int) -> tuple[int, int]:
    """(n1, n2) of the JAX plan: n1 = 2^(logn // 2)."""
    n1 = 1 << (logn // 2)
    return n1, (1 << logn) // n1


def _pow_table(g: int, p: int, length: int) -> np.ndarray:
    """g^e mod p for e < length (a power of two), Python ints, by doubling."""
    t = np.empty(length, dtype=object)
    t[0] = 1
    size, step = 1, g % p
    while size < length:
        t[size:2 * size] = t[:size] * step % p
        step = step * step % p
        size *= 2
    return t


def _digit_planes(m: np.ndarray, planes: int) -> np.ndarray:
    """u64 [rows, k] -> f64 [planes * rows, k]: 16-bit digit plane v in rows
    v rows .. (v + 1) rows - 1."""
    return np.concatenate([((m >> np.uint64(16 * v)) & np.uint64(0xFFFF)).astype(np.float64)
                           for v in range(planes)])


def _byte_planes(m: np.ndarray, planes8: int) -> np.ndarray:
    """u64 [rows, k] -> u8 [planes8, rows, k]: byte v in plane v."""
    return np.stack([((m >> np.uint64(8 * v)) & np.uint64(0xFF)).astype(np.uint8)
                     for v in range(planes8)])


@functools.lru_cache(maxsize=256)
def _prime_tables(p: int, logn: int, R: int) -> dict:
    """The four-step tables of one prime, u64 host arrays (JAX's values)."""
    from ..context import mth_root_of_unity
    n = 1 << logn
    n1, n2 = split_logn(logn)
    m = 2 * n
    psi = mth_root_of_unity(m, p)       # the root family of the NTT tables
    pw = _pow_table(psi, p, m)          # psi^e, e < 2n; omega = psi^2

    def gather(exps, times: int = 1) -> np.ndarray:
        v = pw[np.asarray(exps, dtype=np.int64) % m]
        if times != 1:
            v = v * times % p
        return v.astype(np.uint64)
    a1, a2 = np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64)
    i = np.arange(n, dtype=np.int64)
    o1, o2 = np.outer(a1, a1), np.outer(a2, a2)
    k1i2 = np.outer(a1, a2)
    ninv = pow(n, p - 2, p)
    return {
        # W1[a, b] = w_n1^(a b), w_n1 = omega^n2 = psi^(2 n2); W2 with n1
        "W1": gather(2 * n2 * o1), "W2": gather(2 * n1 * o2),
        "W1i": gather(-2 * n2 * o1), "W2i": gather(-2 * n1 * o2),
        "twid": gather(2 * k1i2, R % p), "twid_i": gather(-2 * k1i2, R % p),
        "twist": gather(i, R % p), "twist_i": gather(-i, ninv * R % p),
        "c_pow": np.array([R % p, (1 << 64) * R % p, (1 << 128) * R % p], dtype=np.uint64),
        "c32": np.array([(1 << 32 * q) * R % p for q in range(4)], dtype=np.uint64),
    }


def planes_of(primes) -> int:
    """16-bit digits that cover the widest prime's residues."""
    bits = max(int(p) - 1 for p in primes).bit_length()
    return max(1, -(-bits // 16))


def planes8_of(primes) -> int:
    """The kernel's byte planes: the bytes of the widest prime's residues,
    rounded up to an instantiation of csrc/ntt4.cu (2, 4 or 8)."""
    bits = max(int(p) - 1 for p in primes).bit_length()
    return next(P8 for P8 in (2, 4, 8) if 8 * P8 >= bits)


def make_ntt4_plan(pctx, dim: int, device=None) -> Ntt4Plan:
    logn = pctx.logn
    if not LOGN_MIN <= logn <= LOGN_MAX:
        raise ValueError(f"logn = {logn}: the four-step NTT supports logn {LOGN_MIN}..{LOGN_MAX}")
    n1, n2 = split_logn(logn)
    primes = [int(p) for p in pctx.primes[:dim]]
    P, P8 = planes_of(primes), planes8_of(primes)
    tabs = [_prime_tables(p, logn, pctx.R) for p in primes]
    b = pctx.basis(dim)

    def words(key):
        return u64_to_torch(np.stack([t[key] for t in tabs]), device)

    def planes(key):
        return torch.from_numpy(np.stack([_digit_planes(t[key], P) for t in tabs])).to(device)

    def bytes8(key):
        return torch.from_numpy(np.stack([_byte_planes(t[key], P8) for t in tabs])).to(device)
    return Ntt4Plan(
        n1=n1, n2=n2, dim=dim, planes=P, planes8=P8,
        ps=u64_to_torch(b.ps, device), pinv=u64_to_torch(b.pinv_mont, device),
        w1dig=planes("W1"), w2dig=planes("W2"), twid=words("twid"), twist=words("twist"),
        w1dig_i=planes("W1i"), w2dig_i=planes("W2i"), twid_i=words("twid_i"),
        twist_i=words("twist_i"), c_pow=words("c_pow"),
        phatinv=u64_to_torch(b.phatinv_mont, device),
        w1u8=bytes8("W1"), w2u8=bytes8("W2"), w1u8_i=bytes8("W1i"), w2u8_i=bytes8("W2i"),
        c32=words("c32"))


# ---------------------------------------------------------------------------
# the plain versions (pure torch, any device)
# ---------------------------------------------------------------------------

def limbs_of(planes: int) -> int:
    """u64 limbs of sum_w S_w 2^(16 w) < 2^(43 + 16 (2P - 2))."""
    return (16 * (2 * planes - 2) + 106) // 64


def plain_ntt4_split(x, plan: Ntt4Plan, rows: int, cols: int, transpose: bool,
                     table) -> torch.Tensor:
    """[..., dim, rows * cols] residues, seen as [rows, cols] a slab, times
    table [dim, K * J] (Montgomery) and transposed if asked, with
    (K, J) = (rows, cols) or (cols, rows) -> f64 [dim, K, B * P * J]: the
    P 16-bit digit planes of each word at [d, k, b P + u, j]."""
    dim, P = plan.dim, plan.planes
    lead = tuple(x.shape[:-2])
    B = math.prod(lead)
    v = x.reshape(B, dim, rows, cols)
    if transpose:
        v = v.transpose(-1, -2)
    K, J = v.shape[-2:]
    if table is not None:
        v = plain_mont_mul(v, table.reshape(dim, K, J), plan.ps.reshape(dim, 1, 1),
                           plan.pinv.reshape(dim, 1, 1))
    d = torch.stack([(v >> (16 * u)) & 0xFFFF for u in range(P)], dim=-2)   # [B, dim, K, P, J]
    return d.permute(1, 2, 0, 3, 4).reshape(dim, K, B * P * J).to(torch.float64)


def plain_ntt4_combine(y, plan: Ntt4Plan, lead: tuple, m: int, j: int, table,
                       scale) -> torch.Tensor:
    """Digit products y [dim, P m, B P j] (W_v X_u at [d, v m + r, b P + u, c])
    -> residues [*lead, dim, m * j] in [0, p): S_w = sum_{u+v=w} W_v X_u,
    carried into u64 limbs 16 bits at a time, reduced as
    sum_g mont(L_g, c_pow_g), then times table [dim, m * j] and scale [dim]
    (Montgomery), either may be None."""
    dim, P = plan.dim, plan.planes
    B = math.prod(lead)
    yv = y.reshape(dim, P, m, B, P, j)
    S = [sum(yv[:, v, :, :, w - v] for v in range(max(0, w - P + 1), min(w, P - 1) + 1))
         for w in range(2 * P - 1)]                                          # [dim, m, B, j]
    NL = limbs_of(P)
    limbs = [torch.zeros_like(S[0], dtype=torch.int64) for _ in range(NL)]
    carry = 0
    for w in range(4 * NL):
        cur = carry + (S[w].to(torch.int64) if w < len(S) else 0)
        limbs[w // 4] = limbs[w // 4] | ((cur & 0xFFFF) << (16 * (w % 4)))
        carry = cur >> 16
    ps, pv = plan.ps.reshape(dim, 1, 1, 1), plan.pinv.reshape(dim, 1, 1, 1)
    cp = plan.c_pow.reshape(dim, 3, 1, 1, 1)
    acc = plain_mont_mul(limbs[0], cp[:, 0], ps, pv)
    for g in range(1, NL):
        acc = plain_addmod(acc, plain_mont_mul(limbs[g], cp[:, g], ps, pv), ps)
    if table is not None:
        acc = plain_mont_mul(acc, table.reshape(dim, m, 1, j), ps, pv)
    if scale is not None:
        acc = plain_mont_mul(acc, scale.reshape(dim, 1, 1, 1), ps, pv)
    return acc.permute(2, 0, 1, 3).reshape(tuple(lead) + (dim, m * j))


def plain_ntt4_stage(x, plan: Ntt4Plan, w: str, rows: int, cols: int, transpose: bool,
                     pre, post, scale) -> torch.Tensor:
    """One stage on [..., dim, rows * cols] residues, each slab seen as
    [rows, cols] and transposed if asked, (K, J) = (rows, cols) or
    (cols, rows): out = post * scale * (W @ (pre * X)) mod p with W the
    plan's K x K matrix `w` (Ntt4Plan.w), pre [dim, K * J] and post
    [dim, K * J] Montgomery tables and scale [dim], each may be None ->
    [..., dim, K * J] in [0, p).  Split, torch.bmm, combine."""
    K, J = (cols, rows) if transpose else (rows, cols)
    y = torch.bmm(plan.w(w, "dig"), plain_ntt4_split(x, plan, rows, cols, transpose, pre))
    return plain_ntt4_combine(y, plan, tuple(x.shape[:-2]), K, J, post, scale)


def transform(a, plan: Ntt4Plan, inverse: bool, scale, stage):
    """The two stages, by the given stage function (the kernel's or the
    plain one)."""
    if a.ndim < 2 or tuple(a.shape[-2:]) != (plan.dim, plan.n1 * plan.n2):
        raise ValueError(f"shape {tuple(a.shape)} does not match the plan "
                         f"[..., {plan.dim}, {plan.n1 * plan.n2}]")
    n1, n2 = plan.n1, plan.n2
    if not inverse:
        # A[i1, i2] = a[i1 n2 + i2] psi^i;  C = W1 A, times omega^(k1 i2)
        C = stage(a, plan, "w1", n1, n2, False, plan.twist, plan.twid, None)
        # Dt[k2, k1] = (W2 C^T)[k2, k1]; out[k1 + n1 k2] = Dt[k2, k1]
        return stage(C, plan, "w2", n1, n2, True, None, None, None)
    # Dt[k2, k1] = ahat[k1 + n1 k2];  Ct = W2^-1 Dt
    Ct = stage(a, plan, "w2_i", n2, n1, False, None, None, None)
    # C = Ct^T times omega^-(k1 i2);  A = W1^-1 C, times psi^-i n^-1 (and phat^-1)
    return stage(Ct, plan, "w1_i", n2, n1, True, plan.twid_i, plan.twist_i, scale)


def plain_ntt4(a, plan: Ntt4Plan) -> torch.Tensor:
    return transform(a, plan, False, None, plain_ntt4_stage)


def plain_intt4(ahat, plan: Ntt4Plan, scale_phatinv: bool = False) -> torch.Tensor:
    return transform(ahat, plan, True, plan.phatinv if scale_phatinv else None,
                      plain_ntt4_stage)


def kernel_ntt4(a, plan: Ntt4Plan) -> torch.Tensor:
    """ntt4 through the CUDA kernel, one launch a stage (raises off a CUDA
    device)."""
    return transform(a, plan, False, None, ntt4_cuda.stage)


def kernel_intt4(ahat, plan: Ntt4Plan, scale_phatinv: bool = False) -> torch.Tensor:
    return transform(ahat, plan, True, plan.phatinv if scale_phatinv else None,
                      ntt4_cuda.stage)


# ---------------------------------------------------------------------------
# dispatch: plain versions on the CPU, the CUDA kernels on a CUDA tensor
# ---------------------------------------------------------------------------

def ntt4(a, plan: Ntt4Plan) -> torch.Tensor:
    """Forward negacyclic NTT of [..., dim, n] residues < p, natural
    four-step order."""
    if a.device.type == "cpu":
        return plain_ntt4(a, plan)
    return kernel_ntt4(a, plan)


def intt4(ahat, plan: Ntt4Plan, scale_phatinv: bool = False) -> torch.Tensor:
    """Inverse of ntt4 (untwist and n^-1 included); scale_phatinv=True also
    multiplies by phat^-1, as the ring engine's scaled inverse does."""
    if ahat.device.type == "cpu":
        return plain_intt4(ahat, plan, scale_phatinv)
    return kernel_intt4(ahat, plan, scale_phatinv)
