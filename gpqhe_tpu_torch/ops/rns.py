"""RNS decompose / CRT reconstruct between limb tensors and residue stacks.

Port of gpqhe_tpu/ops/rns.py (ref: src/rns.c:37-75, src/poly.c:109-120):

  decompose:    limb poly [..., n, K]  ->  residues int64[..., dim, n]  (a mod p_d)
  reconstruct:  residues [..., dim, n]  ->  centered limbs [..., n, KS]

The reconstruct avoids per-coefficient big-int division: y_d = a_d*phat_d^-1
mod p_d, S = sum_d y_d*phat_d (exact 16-bit digit accumulation), and the CRT
overflow multiple alpha = floor(S/P) < dim is estimated in f64 and corrected
exactly with limb compares.

Dispatch: decompose_core / decompose, _digit_partials and _lift run their
plain torch versions (plain_*) on a CPU tensor and the CUDA kernels of
ops/rns_cuda.py on a CUDA tensor; the plain versions call only plain
versions.  The digit product of a reconstruct, _digit_partials, is the
plain 16-bit digit split and an f64 torch.matmul on a CPU tensor, one
launch of rns_cuda.digit_sums (u8 products on the tensor cores) on a CUDA
tensor, whose int64 digit sums the card's lift takes.  LIFT counts the lifts
_lift makes on any device, by their operands: calls, rows, digit_words
(rows x the digit sums a row reads) and limb_words (rows x the limbs a row
writes); LIFT_WIDE counts those of them whose rows have more than WIDE_LIMBS
limbs (on a card, five and six chunks of 32).  DECOMP counts the decomposes
decompose_core makes on any device likewise: calls, rows, limb_words (rows
x K), residue_words (rows x dim), and tc_calls, those that took the card's
tensor-core route (rns_cuda.takes_mma: rows of many limbs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..substrate import bigint
from . import cuda_build
from . import limbs as lb
from . import rns_cuda
from .modmath import plain_mont_mul, u64_to_torch

LIFT = cuda_build.counters({"calls": 0, "rows": 0, "digit_words": 0, "limb_words": 0})
LIFT_WIDE = cuda_build.counters({"calls": 0})
WIDE_LIMBS = 128         # a lift past this many limbs counts in LIFT_WIDE
DECOMP = cuda_build.counters({"calls": 0, "tc_calls": 0, "rows": 0, "limb_words": 0,
                              "residue_words": 0})


@dataclass(frozen=True)
class BasisArrays:
    """Device copies of per-basis constants (u64 bit patterns in int64)."""
    dim: int
    ps: torch.Tensor             # [dim]
    pinv: torch.Tensor           # [dim]
    ninv_mont: torch.Tensor      # [dim]
    r2: torch.Tensor             # [dim]
    phatinv_mont: torch.Tensor   # [dim]
    ninvphat_mont: torch.Tensor  # [dim] n^-1 phat^-1 (scaled-INTT constant)
    zetas: torch.Tensor          # [dim, n]
    zetas_inv: torch.Tensor      # [dim, n]


@dataclass(frozen=True)
class ReconPlan:
    """Constants for CRT reconstruction over one basis (device tensors;
    the limb and digit arrays hold the JAX package's plan values)."""
    dim: int
    ds: int                     # digit width of the accumulator (16-bit digits)
    ks: int                     # output limb count = ds // 2
    logP: int                   # P.bit_length() (fast-path margin validation)
    nd: int                     # 16-bit digits covering one residue (< p)
    phat_digits: torch.Tensor   # f64[nd * dim, ds], see phat_digit_table
    phat_bytes: torch.Tensor    # u8[2 ds, depth], see phat_byte_table
    inv_p: torch.Tensor         # f64[dim] 1/p_d
    negP16: torch.Tensor        # int64[ds] digits of 2^(16 ds) - P
    P_limbs: torch.Tensor       # int64[ks]
    Phalf_limbs: torch.Tensor   # int64[ks] floor(P/2)
    MminusP_limbs: torch.Tensor  # int64[ks] 2^(32 ks) - P


def make_basis_arrays(poly_ctx, dim: int, device, twiddles=None) -> BasisArrays:
    """twiddles: (zetas, zetas_inv) of at least dim primes on the device,
    whose first dim rows the arrays take as views (a ring's shared tables);
    else the arrays get tables of their own."""
    b = poly_ctx.basis(dim)
    if twiddles is None:
        twiddles = (u64_to_torch(poly_ctx.zetas(dim), device),
                    u64_to_torch(poly_ctx.zetas_inv(dim), device))
    return BasisArrays(
        dim=dim,
        ps=u64_to_torch(b.ps, device),
        pinv=u64_to_torch(b.pinv_mont, device),
        ninv_mont=u64_to_torch(b.ninv_mont, device),
        r2=u64_to_torch(b.r2, device),
        phatinv_mont=u64_to_torch(b.phatinv_mont, device),
        ninvphat_mont=u64_to_torch(b.ninvphat_mont, device),
        zetas=twiddles[0][:dim],
        zetas_inv=twiddles[1][:dim],
    )


def phat_digit_table(phat16: np.ndarray, nd: int) -> np.ndarray:
    """f64[nd * dim, ds]: row (t, d), column s holds phat16[d, s - t].

    Operand of the digit matmul in reconstruct_core: the 16-bit digits
    y16[d, t] of y_d times this table give the 16-bit digit columns of
    S = sum_d y_d * phat_d.  Every product is < 2^32 and a column sums at
    most nd * dim of them, so each column sum is < nd * dim * 2^32 < 2^41
    for nd = 4 digits and dim <= 128 primes: integer-exact in f64 (< 2^53),
    and within from_digits16's 2^48 input bound."""
    dim, ds = phat16.shape
    out = np.zeros((nd, dim, ds), dtype=np.float64)
    for t in range(nd):
        out[t, :, t:] = phat16[:, :ds - t]
    return out.reshape(nd * dim, ds)


def phat_byte_table(phat16: np.ndarray, nd8: int) -> np.ndarray:
    """u8[2 ds, depth]: row c, column d * nd8 + t holds byte c - t of
    phat16[d] (0 where c < t), depth = nd8 * dim rounded up to a chunk of
    rns_cuda.digit_sums (DEPTH bytes), the rest zero; nd8 =
    rns_cuda.residue_bytes(nd), the bytes the kernel takes of a residue.

    Operand of the digit product on the tensor cores: the nd8 bytes of each
    y_d against this table give the byte columns of S = sum_d y_d * phat_d
    mod 2^(16 ds); a column sums at most nd8 * dim products below 2^16, so
    it is < 2^31 for nd8 = 8 and dim <= 4128 (exact in the kernel's s32)."""
    dim, ds = phat16.shape
    pb = phat16.astype("<u2").view(np.uint8).reshape(dim, 2 * ds)
    depth = -(-nd8 * dim // rns_cuda.DEPTH) * rns_cuda.DEPTH
    out = np.zeros((2 * ds, depth), dtype=np.uint8)
    for t in range(nd8):
        out[t:, t:nd8 * dim:nd8] = pb[:, :2 * ds - t].T
    return out


def make_recon_plan(poly_ctx, dim: int, device,
                    rows: tuple[int, int] | None = None) -> ReconPlan:
    """The plan over the first dim primes.  rows=(r0, r1) gives the plan of a
    limb shard that holds primes r0..r1-1 of a residue stack: phat_digits,
    phat_bytes and inv_p carry those rows only, digit-major over the local rows as
    reconstruct_sharded stacks the shard's digits, and are zero for a prime
    outside the basis (row >= dim), whose share of the digit sums and of the
    alpha estimate then vanishes under the limb sum (the sub-basis
    reconstruct r = c mod P of the key switch)."""
    b = poly_ctx.basis(dim)
    ds = (b.P.bit_length() + 15) // 16 + 2
    if ds % 2:
        ds += 1
    ks = ds // 2
    M = 1 << (16 * ds)
    phat16 = np.stack([bigint.digits16(ph, ds) for ph in b.phat]).astype(np.uint64)
    inv_p = np.array([1.0 / p for p in b.primes], dtype=np.float64)
    nd = (max(b.primes).bit_length() + 15) // 16
    if rows is not None:
        r0, r1 = rows
        pad = max(r1 - dim, 0)
        phat16 = np.pad(phat16, ((0, pad), (0, 0)))[r0:r1]
        inv_p = np.pad(inv_p, (0, pad))[r0:r1]

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(device)

    def limbs(x):
        return t(bigint.int_to_limbs(x, ks).astype(np.int64))
    return ReconPlan(
        dim=dim, ds=ds, ks=ks, logP=b.P.bit_length(), nd=nd,
        phat_digits=t(phat_digit_table(phat16, nd)),
        phat_bytes=t(phat_byte_table(phat16, rns_cuda.residue_bytes(nd))),
        inv_p=t(inv_p),
        negP16=t(bigint.digits16(M - b.P, ds).astype(np.int64)),
        P_limbs=limbs(b.P), Phalf_limbs=limbs(b.P_half),
        MminusP_limbs=limbs((1 << (32 * ks)) - b.P),
    )


def make_decomp_weights(poly_ctx, dim: int, k_limbs: int) -> np.ndarray:
    """u64[dim, J]: V_j = 2^(64(j+1)) mod p_d, J = ceil(K/2) (so that
    mont_mul(c_j, V_j) == c_j * 2^(64 j) mod p for u64 digits c_j)."""
    j_digits = (k_limbs + 1) // 2
    out = np.empty((dim, j_digits), dtype=np.uint64)
    for d, p in enumerate(poly_ctx.primes[:dim]):
        for j in range(j_digits):
            out[d, j] = pow(2, 64 * (j + 1), p)
    return out


def plain_decompose_core(a, ps, pinv, weights):
    """[..., n, K] limbs -> [..., dim, n] residues; weights int64[dim, J]."""
    k = a.shape[-1]
    j_digits = (k + 1) // 2
    if k % 2:
        a = lb.resize(a, k + 1)
    # u64 digits c_j = limb[2j] | limb[2j+1] << 32 (full 64-bit words)
    c = a[..., 0::2] | (a[..., 1::2] << 32)            # [..., n, J]
    psb = ps[:, None]
    acc = None
    for j in range(j_digits):
        cj = c[..., None, :, j]                         # [..., 1, n]
        term = plain_mont_mul(cj, weights[:, j][:, None], psb, pinv[:, None])
        if acc is None:
            acc = term
        else:
            s = acc + term
            acc = torch.where(s >= psb, s - psb, s)
    return acc


def plain_decompose_signed(a, ps, pinv, weights, src_bits: int):
    """A two's-complement input of src_bits width -> residues honouring the
    sign: a negative value gives p - (|value| mod p), 0 staying 0."""
    hb_limb, hb_bit = divmod(src_bits - 1, 32)
    negmask = ((a[..., hb_limb] >> hb_bit) & 1) == 1
    mag = lb.plain_select(negmask, lb.plain_mask_bits(lb.plain_neg(a), src_bits), a)
    res = plain_decompose_core(mag, ps, pinv, weights)
    neg_res = torch.where(res != 0, ps[:, None] - res, res)
    return torch.where(negmask[..., None, :], neg_res, res)


def decompose_core(a, ps, pinv, weights, src_bits: int | None = None):
    """[..., n, K] limbs -> [..., dim, n] residues; src_bits: the input is a
    two's-complement value of that width (plain_decompose_signed)."""
    k = a.shape[-1]
    rows = a.numel() // k if k else 0
    DECOMP["calls"] += 1
    DECOMP["rows"] += rows
    DECOMP["limb_words"] += rows * k
    DECOMP["residue_words"] += rows * ps.numel()
    if a.device.type == "cpu":
        if src_bits is None:
            return plain_decompose_core(a, ps, pinv, weights)
        return plain_decompose_signed(a, ps, pinv, weights, src_bits)
    DECOMP["tc_calls"] += rns_cuda.takes_mma(k)
    return rns_cuda.decompose(a, ps, pinv, weights, src_bits)


def decompose(a, ba: BasisArrays, weights, src_bits: int | None = None):
    """[..., n, K] -> [..., dim, n]: a mod p_d per prime
    (ref: src/rns.c:37-48; input is a nonnegative representative, or a
    two's-complement one of src_bits width)."""
    return decompose_core(a, ba.ps, ba.pinv, weights, src_bits)


def reconstruct_core(res, ps, pinv, phatinv_mont, plan: ReconPlan,
                     center: bool = True, k_out: int | None = None,
                     pre_scaled: bool = False):
    """CRT reconstruction of [..., dim, n] residues.

    When k_out is given (center=True only — reconstruct() enforces this),
    the truncated fast path runs: only the low 2*k_out digit columns of S
    are accumulated.  With v = S mod P and alpha_true = floor(S/P), the f64
    estimate af = S/P + eps has |eps| < dim * 2^-51, so floor(af) can differ
    from alpha_true only when v/P is within |eps| of 0 or 1; the caller's
    magnitude margin (|value| <= P/4) keeps frac = af - floor(af) inside
    [0, 1/4+eps] u [3/4-eps, 1+eps], and subtracting P exactly when
    frac > 1/2 yields the centered value mod 2^(32 k_out).  center=False
    always takes the exact full-width path, whose limb compares correct
    alpha by +-1.  So the output is exact whatever order the f64 sum for af
    is taken in."""
    fast = k_out is not None
    scale = None if pre_scaled else (phatinv_mont, ps, pinv)
    kd = min(2 * k_out, plan.ds) if fast else plan.ds
    s_digits, af = _digit_partials(res, plan, kd, scale)
    return _lift(s_digits, af, plan, center, k_out)


def plain_digit_split(y, nd: int, inv_p, scale=None):
    """[..., dim, n] residues -> (Y f64 [..., n, nd * dim], af f64 [..., n]):
    column t * dim + d of Y holds the 16-bit digit t of y_d, af = sum_d
    y_d / p_d estimates S / P.  scale = (phatinv_mont, ps, pinv): y_d is
    first multiplied by phatinv_d (Montgomery form)."""
    if scale is not None:
        phatinv_mont, ps, pinv = scale
        y = plain_mont_mul(y, phatinv_mont[:, None], ps[:, None], pinv[:, None])
    dim = y.shape[-2]
    n = y.shape[-1]
    # 16-bit digits of y: [..., nd, dim, n] -> [..., n, nd*dim]
    y16 = torch.stack([(y >> (16 * t)) & 0xFFFF for t in range(nd)], dim=-3)
    Y = y16.reshape(y.shape[:-2] + (nd * dim, n)).transpose(-1, -2)
    af = (y.to(torch.float64) * inv_p[:, None]).sum(-2)
    return Y.to(torch.float64), af


def plain_digit_partials(y, plan: ReconPlan, kd: int, scale=None):
    """(digit sums f64[..., n, kd] of S = sum_d y_d * phat_d over the low kd
    16-bit digit columns, f64[..., n] estimate of S / P) from the y_d of the
    primes whose rows plan.phat_digits and plan.inv_p hold (scale: see
    plain_digit_split).  The digit sums are integers below 2^53, exact in
    f64."""
    Y, af = plain_digit_split(y, plan.nd, plan.inv_p, scale)
    return torch.matmul(Y, plan.phat_digits[:, :kd]), af


def _digit_partials(y, plan: ReconPlan, kd: int, scale=None):
    """plain_digit_partials on a CPU tensor; on a CUDA tensor one launch of
    rns_cuda.digit_sums, whose int64 digit sums are the plain version's
    value mod 2^(16 kd) (which the lift reads), not its columns."""
    if y.device.type == "cpu":
        return plain_digit_partials(y, plan, kd, scale)
    return rns_cuda.digit_sums(y, plan, kd, scale)


def plain_lift(s_digits, af, plan: ReconPlan, center: bool, k_out: int | None):
    """Digit sums and the S / P estimate -> limbs (see reconstruct_core)."""
    kd = s_digits.shape[-1]
    # alpha = floor(S / P) estimated in f64, corrected exactly below
    alpha = torch.clamp(torch.floor(af), 0.0, float(plan.dim))
    # S - alpha*P == S + alpha*(M - P) mod M
    s_digits = (s_digits.to(torch.int64)
                + alpha.to(torch.int64)[..., None] * plan.negP16[:kd])
    if k_out is None:
        r = lb.plain_from_digits16(s_digits, plan.ks)
        # correct alpha off-by-one: E in (-P, 2P)
        P = plan.P_limbs.expand(r.shape)
        r = lb.plain_select(lb.plain_geq_const(r, plan.MminusP_limbs), lb.plain_add(r, P), r)
        r = lb.plain_select(lb.plain_geq_const(r, plan.P_limbs), lb.plain_sub(r, P), r)
        if center:
            # smod P (ref: src/types.c:108-113 with q=P)
            r = lb.plain_select(lb.plain_geq_const(r, plan.Phalf_limbs), lb.plain_sub(r, P), r)
        return r
    r = lb.plain_from_digits16(s_digits, k_out)
    frac = af - alpha
    return lb.plain_select(frac > 0.5,
                           lb.plain_sub(r, plan.P_limbs[:k_out].expand(r.shape)), r)


def _lift(s_digits, af, plan: ReconPlan, center: bool, k_out: int | None):
    kout = plan.ks if k_out is None else k_out
    rows = af.numel()
    LIFT["calls"] += 1
    LIFT_WIDE["calls"] += kout > WIDE_LIMBS
    LIFT["rows"] += rows
    LIFT["digit_words"] += rows * min(s_digits.shape[-1], 2 * kout)
    LIFT["limb_words"] += rows * kout
    if s_digits.device.type == "cpu":
        return plain_lift(s_digits, af, plan, center, k_out)
    return rns_cuda.lift(s_digits, af, plan, center, k_out)


def reconstruct_sharded(res: dict, consts: dict, psum, center: bool = True) -> dict:
    """CRT reconstruction of a residue stack whose primes are spread over
    shards (the torch form of the JAX reconstruct_core's axis_name).

    res[k]: shard k's residues [..., dim_k, n]; consts[k]: its (ps, pinv,
    phatinv_mont, plan), plan from make_recon_plan(..., rows=...) on the
    shard's device; psum: {k: tensor} -> {k: sum over the shards that
    reconstruct together}, the one place where data crosses shards.  Every
    shard gets the limbs [..., n, ks].

    Always the exact full-width path: the digit partials are integers far
    below 2^53 (f64 on the CPU, int64 from rns_cuda.digit_sums on a card,
    each shard's value mod 2^(16 ds) either way), summed as int64 (the
    card's lift takes no other, and a mesh of the card and the host sums
    both kinds), so their sum is exact in any order, and the +-1 limb
    compares make the result independent of the last bits of the f64 sum
    of the alpha estimate.  The output therefore equals reconstruct()'s
    whatever the number of shards."""
    s_part, af_part = {}, {}
    for k, r in res.items():
        ps, pinv, phatinv_mont, plan = consts[k]
        s, af_part[k] = _digit_partials(r, plan, plan.ds, (phatinv_mont, ps, pinv))
        s_part[k] = s.to(torch.int64)
    s_sum, af_sum = psum(s_part), psum(af_part)
    return {k: _lift(s_sum[k], af_sum[k], consts[k][3], center, None) for k in res}


def reconstruct(res, ba: BasisArrays, plan: ReconPlan, center: bool = True,
                k_out: int | None = None, bound_bits: int | None = None,
                pre_scaled: bool = False):
    """[..., dim, n] -> [..., n, ks] limbs mod 2^(32 ks).

    center=True: the exact centered integer (CRT lift then smod P), two's
    complement.  center=False: the nonnegative residue in [0, P).
    k_out: compute the value mod 2^(32 k_out) only; engages for center=True
    with a proven bound |value| < 2^bound_bits and >= 3 bits of margin."""
    fast_ok = (k_out is not None and k_out <= plan.ks
               and center
               and bound_bits is not None
               and plan.logP - bound_bits >= 3)
    return reconstruct_core(res, ba.ps, ba.pinv, ba.phatinv_mont, plan,
                            center=center, k_out=k_out if fast_ok else None,
                            pre_scaled=pre_scaled)
