"""The elementwise CUDA kernels (csrc/modmath.cu, csrc/rns.cu, csrc/limbs.cu)
without a card: a numpy model of each kernel's per-thread algorithm, held
equal to the plain torch version and to the JAX function on edge words, and
the dispatch and argument checks around them.

The models follow the .cu code line by line on native u64 words, one
vectorised lane per thread (a coefficient or a row):
  - mont.cuh / modmath.cu: mont_reduce with __umul64hi, mont_mul, mulmod,
    addmod, submod, and the fused cross terms, key products and sums;
  - rns.cu decompose (tests/torch_rns_model.py): sum_i limb_i c_i with
    c_i = 2^(32 i) R mod p made from the weights, 32 x 64-bit products in a
    128-bit sum, one Montgomery reduction a group of 256 limbs;
    the signed form (a negative row's limbs masked to src_bits, then
    2^src_bits mod p subtracted);
  - rns.cu lift: alpha = clamp(floor(af), 0, dim), the sequential 16-bit
    carry walk, then the fast path (frac > 1/2 -> -P) or the exact one
    (+-P corrections, centring);
  - limbs.cu: the carry and borrow walks, the top-down compare, the shifts
    with the rounding bit, the digit carry walk.
The edge words: 0, 1, p - 1, 2^63, 2^64 - 1, all-0xFFFFFFFF limbs (a carry
through every limb), zero rows (a borrow through every limb), and the CRT
boundaries of tests/test_torch_rns.py (0, +-(2^bound - 1), P - 1, inv_p off
by 1 + 2^-22).  Both chains' primes (59-bit and logp=29).
"""

import ast
import dataclasses
import functools
import importlib
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import limbs as jl
from gpqhe_tpu.ops import modmath as jm
from gpqhe_tpu.ops import rns as jr
from gpqhe_tpu.substrate import bigint

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import cuda_build, limbs_cuda, modmath_cuda, rns_cuda
from gpqhe_tpu_torch.ops import limbs as tl
from gpqhe_tpu_torch.ops import modmath as tm
from gpqhe_tpu_torch.ops import rns as tr
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch

import torch_rns_model as rm
import torch_rowwarp_model as rt
from chip_smoke import EDGE_K, EDGE_ROWS, elementwise_edge_cases

torch.set_num_threads(1)

U = np.uint64
M32 = U(0xFFFFFFFF)
LOGN = 6
N = 1 << LOGN
CHAINS = {59: (JPolyContext(LOGN, q=1 << 20, dim_cap=24), PolyContext(LOGN, q=1 << 20, dim_cap=24)),
          29: (JPolyContext(LOGN, q=1 << 20, logp=29, dim_cap=24),
               PolyContext(LOGN, q=1 << 20, logp=29, dim_cap=24))}


# ---------------------------------------------------------------------------
# the per-thread models (numpy u64, wrapping like the device's words)
# ---------------------------------------------------------------------------

def umulhi(a, b):
    """__umul64hi on u64 arrays."""
    with np.errstate(over="ignore"):
        al, ah, bl, bh = a & M32, a >> U(32), b & M32, b >> U(32)
        ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
        cross = (ll >> U(32)) + (lh & M32) + (hl & M32)
        return hh + (lh >> U(32)) + (hl >> U(32)) + (cross >> U(32))


def m_mont_reduce(hi, lo, p, pinv):
    with np.errstate(over="ignore"):
        t = umulhi(lo * pinv, p)
        return np.where(hi < t, hi - t + p, hi - t)


def m_mont_mul(a, b, p, pinv):
    with np.errstate(over="ignore"):
        return m_mont_reduce(umulhi(a, b), a * b, p, pinv)


def m_mulmod(a, b, p, pinv, r2):
    return m_mont_mul(m_mont_mul(a, b, p, pinv), r2, p, pinv)


def m_addmod(a, b, p):
    with np.errstate(over="ignore"):
        s = a + b
        return np.where(s >= p, s - p, s)


def m_submod(a, b, p):
    with np.errstate(over="ignore"):
        return np.where(a < b, a - b + p, a - b)


def m_decompose(a, w, p, pinv, src_bits=0):
    """rns.cu decompose_kernel's arithmetic (tests/torch_rns_model.py): a
    u64[rows, K] limbs, w u64[dim, J] -> u64[dim, rows]."""
    return rm.decompose_rows(a, w, p, pinv, src_bits)[0]


def m_add(a, b, carry=None):
    out = np.empty(np.broadcast_shapes(a.shape, b.shape), dtype=U)
    c = np.zeros(out.shape[:-1], dtype=U) if carry is None else carry.astype(U)
    for i in range(out.shape[-1]):
        s = a[..., i] + b[..., i] + c
        out[..., i] = s & M32
        c = s >> U(32)
    return out


def m_sub(a, b):
    out = np.empty(np.broadcast_shapes(a.shape, b.shape), dtype=U)
    c = np.zeros(out.shape[:-1], dtype=U)
    with np.errstate(over="ignore"):
        for i in range(out.shape[-1]):
            y = b[..., i] + c
            c = (a[..., i] < y).astype(U)
            out[..., i] = (a[..., i] - y) & M32
    return out


def m_geq(a, c):
    c = np.broadcast_to(c, a.shape)
    ge = np.ones(a.shape[:-1], dtype=bool)
    decided = np.zeros(a.shape[:-1], dtype=bool)
    for i in range(a.shape[-1] - 1, -1, -1):
        diff = (a[..., i] != c[..., i]) & ~decided
        ge = np.where(diff, a[..., i] > c[..., i], ge)
        decided |= diff
    return ge


def m_mask(a, nbits):
    full, rem = divmod(nbits, 32)
    out = a.copy()
    for i in range(a.shape[-1]):
        if i > full or (i == full and rem == 0):
            out[..., i] = 0
        elif i == full:
            out[..., i] &= U((1 << rem) - 1)
    return out


def m_rshift_round(a, t, k):
    """limbs.cu rshift_round_row: the rounding bit first, then one carry walk."""
    K = a.shape[-1]

    def limb(i):
        return a[..., i] if i < K else np.zeros(a.shape[:-1], dtype=U)
    s, r = divmod(t, 32)
    carry = np.zeros(a.shape[:-1], dtype=U)
    if t > 0:
        hb_limb, hb_bit = divmod(t - 1, 32)
        h = limb(hb_limb)
        low = (h & U((1 << hb_bit) - 1)) != 0 if hb_bit else np.zeros(h.shape, dtype=bool)
        for i in range(hb_limb):
            low |= limb(i) != 0
        carry = (((h >> U(hb_bit)) & U(1)) == 1) & low
        carry = carry.astype(U)
    out = np.empty(a.shape[:-1] + (k,), dtype=U)
    for i in range(k):
        q = limb(s + i)
        if r:
            q = ((q >> U(r)) | (limb(s + i + 1) << U(32 - r))) & M32
        v = q + carry
        out[..., i] = v & M32
        carry = v >> U(32)
    return out


def m_rescale(a, t, nbits, k_out):
    q = m_mask(m_rshift_round(a, t, a.shape[-1]), nbits)
    out = np.zeros(a.shape[:-1] + (k_out,), dtype=U)
    k = min(k_out, a.shape[-1])
    out[..., :k] = q[..., :k]
    return out


def m_from_digits(d, k_out):
    """The carry walk of limbs.cu (from_digits16) and rns.cu (lift)."""
    out = np.empty(d.shape[:-1] + (k_out,), dtype=U)
    carry = np.zeros(d.shape[:-1], dtype=U)
    lo = carry
    for i in range(2 * k_out):
        v = carry + (d[..., i] if i < d.shape[-1] else U(0))
        carry = v >> U(16)
        if i & 1:
            out[..., i // 2] = lo | ((v & U(0xFFFF)) << U(16))
        else:
            lo = v & U(0xFFFF)
    return out


def m_lift(s, af, dim, negP16, k_out, center, P, Ph, MmP, ks):
    """rns.cu lift_kernel: s u64[rows, kd] digit sums, af f64[rows]."""
    alpha = np.minimum(np.maximum(np.floor(af), 0.0), float(dim))
    ai = alpha.astype(U)
    kd = s.shape[-1]
    kout = ks if k_out is None else k_out
    d = np.zeros(s.shape[:-1] + (2 * kout,), dtype=U)
    m = min(kd, 2 * kout)
    d[..., :m] = s[..., :m] + ai[..., None] * negP16[:m]
    r = m_from_digits(d, kout)
    if k_out is None:
        r = np.where(m_geq(r, MmP)[..., None], m_add(r, P), r)
        r = np.where(m_geq(r, P)[..., None], m_sub(r, P), r)
        if center:
            r = np.where(m_geq(r, Ph)[..., None], m_sub(r, P), r)
        return r
    return np.where((af - alpha > 0.5)[..., None], m_sub(r, P[:k_out]), r)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _t(x):
    """u64 / bool numpy -> torch (int64 bit patterns)."""
    x = np.asarray(x)
    return torch.from_numpy(x.copy()) if x.dtype == bool else u64_to_torch(x)


def _u(t):
    return t.numpy() if t.dtype == torch.bool else torch_to_u64(t)


def _j(fn, *args, **static):
    return np.asarray(jax.jit(functools.partial(fn, **static))(*(jnp.asarray(x) for x in args)))


def _residues(rng, primes, shape):
    p = np.asarray(primes, dtype=U)[:, None]
    x = rng.integers(0, 1 << 63, size=shape, dtype=U) % p
    x[..., :3] = np.concatenate([np.zeros_like(p), np.ones_like(p), p - U(1)], axis=1)
    return x


def _words(rng, shape):
    x = rng.integers(0, (1 << 64) - 1, size=shape, dtype=U, endpoint=True)
    x[..., :3] = np.array([0, 1 << 63, (1 << 64) - 1], dtype=U)
    return x


def _limbs(rng, shape):
    a = rng.integers(0, 1 << 32, size=shape, dtype=U)
    a[..., 0, :] = M32
    a[..., 1, :] = 0
    a[..., 2, :] = M32
    a[..., 2, -1] = 0
    a[..., 3, :] = np.arange(shape[-1], dtype=U)
    return a


def _consts(pctx, dim):
    b = pctx.basis(dim)
    return (np.asarray(b.ps, dtype=U), np.asarray(b.pinv_mont, dtype=U), np.asarray(b.r2, dtype=U))


# ---------------------------------------------------------------------------
# K5: modmath
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("fn", ["mont_reduce", "mont_mul", "mulmod", "to_mont", "addmod", "submod"])
def test_modmath_model(fn, logp):
    jp, tp = CHAINS[logp]
    dim = 6
    rng = np.random.default_rng(logp + len(fn))
    p, pinv, r2 = (v[:, None] for v in _consts(tp, dim))
    x, y = _residues(rng, p[:, 0], (dim, N)), _residues(rng, p[:, 0], (dim, N))[:, ::-1].copy()
    if fn == "mont_reduce":
        hi, lo = x, _words(rng, (dim, N))           # hi < p, any lo
        want = m_mont_reduce(hi, lo, p, pinv)
        torch_out = tm.mont_reduce(_t(hi), _t(lo), _t(p), _t(pinv))
        jax_out = _j(jm.mont_reduce, hi, lo, p, pinv)
    elif fn == "mont_mul":
        w = _words(rng, (dim, N))                    # any u64 against y < p
        want = m_mont_mul(w, y, p, pinv)
        torch_out = tm.plain_mont_mul(_t(w), _t(y), _t(p), _t(pinv))
        jax_out = _j(jm.mont_mul, w, y, p, pinv)
    elif fn == "mulmod":
        want = m_mulmod(x, y, p, pinv, r2)
        torch_out = tm.plain_mulmod(_t(x), _t(y), _t(p), _t(pinv), _t(r2))
        jax_out = _j(jm.mulmod, x, y, p, pinv, r2)
        assert np.array_equal(want, (x.astype(object) * y.astype(object)) % p.astype(object))
    elif fn == "to_mont":
        want = m_mont_mul(x, r2, p, pinv)
        torch_out = tm.plain_to_mont(_t(x), _t(p), _t(pinv), _t(r2))
        jax_out = _j(jm.to_mont, x, p, pinv, r2)
    elif fn == "addmod":
        want = m_addmod(x, y, p)
        torch_out = tm.plain_addmod(_t(x), _t(y), _t(p))
        jax_out = _j(jm.addmod, x, y, p)
    else:
        want = m_submod(x, y, p)
        torch_out = tm.plain_submod(_t(x), _t(y), _t(p))
        jax_out = _j(jm.submod, x, y, p)
    assert np.array_equal(want, _u(torch_out))
    assert np.array_equal(want, jax_out)


@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("entry", ["cross_terms", "key_products", "mulmod_sum", "mulmod_sum_times",
                                   "summod"])
def test_fused_modmath_model(entry, logp):
    """The fused entries' kernels (modmath.cu cross, keyprod and sum) against
    the plain versions and the JAX package's mulmod / addmod chains, with a
    batch axis, a broadcast key and a strided key-bank view."""
    jp, tp = CHAINS[logp]
    dim, B, M = 5, 3, 4
    rng = np.random.default_rng(7 * logp + len(entry))
    p, pinv, r2 = (v[:, None] for v in _consts(tp, dim))
    P, V, R = _t(p), _t(pinv), _t(r2)

    def jmul(a, b):
        return _j(jm.mulmod, a, b, p, pinv, r2)

    def jadd(a, b):
        return _j(jm.addmod, a, b, p)
    if entry == "cross_terms":
        x = _residues(rng, p[:, 0], (4, B, dim, N))
        x0, x1, y0, y1 = x
        want = np.stack([m_mulmod(x0, y0, p, pinv, r2),
                         m_addmod(m_mulmod(x0, y1, p, pinv, r2), m_mulmod(x1, y0, p, pinv, r2), p),
                         m_mulmod(x1, y1, p, pinv, r2)])
        got = tm.cross_terms(_t(x), P, V, R)
        jax_out = np.stack([jmul(x0, y0), jadd(jmul(x0, y1), jmul(x1, y0)), jmul(x1, y1)])
    elif entry == "key_products":
        x = _residues(rng, p[:, 0], (B, dim, N))
        bank = _residues(rng, tp.primes[:dim + 3], (2, dim + 3, N))[:, :dim]   # a larger key's rows
        want = np.stack([m_mulmod(x, bank[0], p, pinv, r2), m_mulmod(x, bank[1], p, pinv, r2)])
        got = tm.key_products(_t(x), _t(bank[0]), _t(bank[1]), P, V, R)
        jax_out = np.stack([jmul(x, bank[0]), jmul(x, bank[1])])
    elif entry == "summod":
        x = _residues(rng, p[:, 0], (M + 1, dim, N))
        want = x[0]
        for m in range(1, M + 1):
            want = m_addmod(want, x[m], p)
        got = tm.summod(_t(x), P)[None]
        want, jax_out = want[None], functools.reduce(jadd, list(x))[None]
    else:
        x, y = _residues(rng, p[:, 0], (M, dim, N)), _residues(rng, p[:, 0], (M, dim, N))
        bank = _residues(rng, tp.primes[:dim + 2], (2, M, dim + 2, N))
        ws = [bank[0][:, :dim], bank[1][:, :dim]] if entry == "mulmod_sum_times" else []
        t = m_mulmod(x, y, p, pinv, r2)
        jt = jmul(x, y)
        terms = [m_mulmod(t, w, p, pinv, r2) for w in ws] or [t]
        jterms = [jmul(jt, w) for w in ws] or [jt]
        want, jax_out = [], []
        for term, jterm in zip(terms, jterms):
            s, js = term[0], jterm[0]
            for m in range(1, M):
                s, js = m_addmod(s, term[m], p), jadd(js, jterm[m])
            want.append(s)
            jax_out.append(js)
        want, jax_out = np.stack(want), np.stack(jax_out)
        got = tm.mulmod_sum(_t(x), _t(y), P, V, R, ws=[_t(w) for w in ws])
    assert np.array_equal(want, _u(got))
    assert np.array_equal(want, jax_out)


# ---------------------------------------------------------------------------
# K4: decompose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("k,src", [(14, None), (7, None), (14, 448), (14, 437), (7, 224), (3, 65)])
def test_decompose_model(k, src, logp):
    """The digit walk (odd limb counts pad a zero limb) and its signed form,
    against the plain version, the JAX decompose and Python integers."""
    jp, tp = CHAINS[logp]
    dim = 24
    rng = np.random.default_rng(k + (src or 0) + logp)
    a = _limbs(rng, (N, k))
    ps, pinv, _ = _consts(tp, dim)
    w = tr.make_decomp_weights(tp, dim, k)
    want = m_decompose(a, w, ps, pinv, src or 0)
    got = tr.decompose_core(_t(a), _t(ps), _t(pinv), _t(w), src_bits=src)
    assert np.array_equal(want, _u(got))
    vals = bigint.limbs_to_ints(a.astype(np.uint32))
    if src:
        # a value with bit src - 1 set is negative: -(2^src - (a mod 2^src));
        # any other is taken as it stands (ring/poly.py's signed decompose)
        vals = [(v % (1 << src)) - (1 << src) if (v >> (src - 1)) & 1 else v for v in vals]
    else:
        jba = jr.make_basis_arrays(jp, dim)
        assert np.array_equal(want, _j(lambda x: jr.decompose(x, jba, jr.make_decomp_weights(
            jp, dim, k)), a.astype(np.uint32)))
    ints = np.array([[v % p for v in vals] for p in tp.primes[:dim]], dtype=object)
    assert np.array_equal(want.astype(object), ints)


# ---------------------------------------------------------------------------
# K6: the CRT lift
# ---------------------------------------------------------------------------

def _edge_residues(vals, primes):
    v = np.asarray(vals, dtype=object)
    return np.stack([(v % p).astype(U) for p in primes])


@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("path", ["fast", "exact", "nonneg", "skewed"])
def test_lift_model(path, logp):
    """digit_split (plain) + matmul + the lift model against plain_lift, the
    JAX reconstruct and Python integers, at the reconstruct boundaries:
    0, +-1, +-(2^bound - 1), P - 1 (center=False) and an f64 estimate made
    to miss by inv_p (1 + 2^-22) (the exact path's +-1 corrections)."""
    jp, tp = CHAINS[logp]
    dim = 8
    jba, jplan = jr.make_basis_arrays(jp, dim), jr.make_recon_plan(jp, dim)
    tba, tplan = tr.make_basis_arrays(tp, dim, "cpu"), tr.make_recon_plan(tp, dim, "cpu")
    if path == "skewed":
        jplan = dataclasses.replace(jplan, inv_p=jplan.inv_p * (1.0 + np.float64(2.0 ** -22)))
        tplan = dataclasses.replace(tplan, inv_p=tplan.inv_p * (1.0 + 2.0 ** -22))
    b = tp.basis(dim)
    bound = tplan.logP - 40
    big = (1 << bound) - 1
    if path == "nonneg":
        vals = [0, 1, b.P - 1, b.P // 2, b.P // 2 + 1, 12345, b.P - 12345]
    else:
        vals = [0, 1, -1, big, -big, big - 1, -(big - 1), 3, -3]
    vals = (vals * (N // len(vals) + 1))[:N]
    res = _edge_residues(vals, b.primes)
    center = path != "nonneg"
    k_out = max(2, (bound + 63) // 32) if path == "fast" else None
    kd = min(2 * k_out, tplan.ds) if k_out else tplan.ds
    sd, af = tr.plain_digit_partials(_t(res), tplan, kd, (tba.phatinv_mont, tba.ps, tba.pinv))
    model = m_lift(sd.numpy().astype(U), af.numpy(), tplan.dim, torch_to_u64(tplan.negP16),
                   k_out, center, torch_to_u64(tplan.P_limbs), torch_to_u64(tplan.Phalf_limbs),
                   torch_to_u64(tplan.MminusP_limbs), tplan.ks)
    plain = _u(tr.plain_lift(sd, af, tplan, center, k_out))
    assert np.array_equal(model, plain)
    launched, lp = rt.run_lift(sd, af, tplan, center, k_out)   # rns.cu as launched
    assert lp["chunks"] == 1 and np.array_equal(model, launched)
    kw = dict(center=center, k_out=k_out or (tplan.ks if path == "nonneg" else None),
              bound_bits=bound if k_out else None)
    jax_out = _j(functools.partial(jr.reconstruct, ba=jba, plan=jplan, **kw), res)
    assert np.array_equal(model, jax_out.astype(U))
    if path == "fast":
        assert bigint.limbs_to_ints(model.astype(np.uint32)) == [v % (1 << (32 * k_out))
                                                               for v in vals]
    elif path == "nonneg":
        assert bigint.limbs_to_ints(model.astype(np.uint32)) == [v % b.P for v in vals]
    else:
        assert bigint.limbs_to_signed_ints(model.astype(np.uint32)) == vals


def test_digit_split_is_the_matmul_operand():
    """plain_digit_split's Y column t * dim + d holds digit t of y_d, as
    rns.cu's digit_split writes it; af = sum_d y_d / p_d."""
    tp = CHAINS[59][1]
    dim = 5
    plan = tr.make_recon_plan(tp, dim, "cpu")
    y = _residues(np.random.default_rng(3), tp.primes[:dim], (2, dim, N))
    Y, af = tr.plain_digit_split(_t(y), plan.nd, plan.inv_p)
    for t in range(plan.nd):
        assert np.array_equal(Y[..., t * dim:(t + 1) * dim].numpy(),
                              np.swapaxes((y >> U(16 * t)) & U(0xFFFF), -1, -2).astype(float))
    want = (y.astype(np.float64) / np.asarray(tp.primes[:dim], dtype=float)[:, None]).sum(-2)
    assert np.allclose(af.numpy(), want, rtol=2.0 ** -45, atol=0)


# ---------------------------------------------------------------------------
# K7: limbs
# ---------------------------------------------------------------------------

LIMB_OPS = ["add", "sub", "neg", "add_scalar_bit", "select", "geq_const", "mask_bits",
            "rshift_round", "rshift_round_mask", "from_digits16"]


@pytest.mark.parametrize("k", [1, 7, 14, 125])
@pytest.mark.parametrize("op", LIMB_OPS)
def test_limbs_model(op, k):
    rng = np.random.default_rng(len(op) * 131 + k)
    a, b = _limbs(rng, (N, k)), _limbs(rng, (N, k))
    b[0] = 1                      # 0xFF..FF + 1 ripples through every limb
    b[1] = M32                    # 0 - 0xFF..FF borrows through every limb
    b[5] = a[5]                   # equal rows
    b[6] = a[6]
    b[6, -1] ^= U(1)              # equal except the top limb
    bit = rng.integers(0, 2, N).astype(bool)
    bit[0] = True
    a32 = a.astype(np.uint32)
    if op == "add":
        want, got, jax_out = m_add(a, b), tl.add(_t(a), _t(b)), _j(jl.add, a32, b.astype(np.uint32))
        args = (_t(a), _t(b))
    elif op == "sub":
        want, got, jax_out = m_sub(a, b), tl.sub(_t(a), _t(b)), _j(jl.sub, a32, b.astype(np.uint32))
        args = (_t(a), _t(b))
    elif op == "neg":
        want, got, jax_out = m_sub(np.zeros_like(a), a), tl.neg(_t(a)), _j(jl.neg, a32)
        args = (_t(a),)
    elif op == "add_scalar_bit":
        want = m_add(a, np.zeros_like(a), bit)
        got, jax_out = tl.add_scalar_bit(_t(a), _t(bit)), _j(jl.add_scalar_bit, a32, bit)
        args = (_t(a), _t(bit))
    elif op == "select":
        want = np.where(bit[:, None], a, b)
        got, jax_out = tl.select(_t(bit), _t(a), _t(b)), _j(jl.select, bit, a32,
                                                           b.astype(np.uint32))
        args = (_t(bit), _t(a), _t(b))
    elif op == "geq_const":
        c = a[5]
        want, got, jax_out = m_geq(a, c), tl.geq_const(_t(a), _t(c)), _j(jl.geq_const, a32,
                                                                         c.astype(np.uint32))
        args = (_t(a), _t(c))
    elif op == "mask_bits":
        nbits = 32 * k - 5
        want, got = m_mask(a, nbits), tl.mask_bits(_t(a), nbits)
        jax_out = _j(jl.mask_bits, a32, nbits=nbits)
        args = (_t(a), nbits)
    elif op == "rshift_round":
        t, k_out = (50, k + 1) if k > 2 else (5, k)
        a[8] = 0
        a[8, t // 32] = U(1 << (t % 32 - 1)) if k > 2 else U(1 << 4)   # a tie: rounds down
        want, got = m_rshift_round(a, t, k_out), tl.rshift_round(_t(a), t, k_out)
        jax_out = _j(jl.rshift_round, a.astype(np.uint32), t=t, k_out=k_out)
        args = (_t(a), t, k_out)
    elif op == "rshift_round_mask":
        t, nbits, k_out = min(50, 32 * k - 1), max(1, 32 * k - 60), max(1, k - 1)
        want, got = m_rescale(a, t, nbits, k_out), tl.rshift_round_mask(_t(a), t, nbits, k_out)
        jax_out = np.zeros_like(want)
        q = _j(jl.mask_bits, _j(jl.rshift_round, a32, t=t), nbits=nbits)
        jax_out[:, :min(k_out, q.shape[-1])] = q[:, :k_out]
        args = (_t(a), t, nbits, k_out)
    else:
        d = rng.integers(0, 1 << 48, (N, 2 * k + 3), dtype=U)
        d[0] = 0xFFFF                 # every digit propagates ...
        d[0, 0] = 0x10000             # ... a carry generated at the bottom
        d[1] = (1 << 48) - 1
        want = m_from_digits(d, k)
        got = tl.from_digits16(torch.from_numpy(d.astype(np.float64)), k)   # the matmul's f64
        assert torch.equal(got, tl.from_digits16(_t(d), k))
        jax_out = _j(jl.from_digits16, d, k_out=k)
        args = (torch.from_numpy(d.astype(np.float64)), k)
    assert np.array_equal(want, _u(got))
    assert np.array_equal(want, jax_out.astype(want.dtype))
    # the kernel's work split (limbs.cu as launched, in numpy) on the same inputs
    assert np.array_equal(want, _u(_row_kernel(op, *args)[0]))


# ---------------------------------------------------------------------------
# K7 and the lift as launched: the row kernels' work split (rowwarp.cuh)
# ---------------------------------------------------------------------------

# ops/limbs.py's CUDA branch of each entry, up to its launch
_CUDA_BRANCH = {
    "add": lambda a, b: limbs_cuda.binary("add", a, b),
    "sub": lambda a, b: limbs_cuda.binary("sub", a, b),
    "neg": lambda a: limbs_cuda.launch("neg", tuple(a.shape), a.shape[-1], a),
    "add_scalar_bit": lambda a, bit: limbs_cuda.launch("add_scalar_bit", tuple(a.shape),
                                                       a.shape[-1], a, bit=bit),
    "select": lambda m, a, b: limbs_cuda.select(m, a, b),
    "geq_const": lambda a, c: limbs_cuda.geq_const(a, c),
    "mask_bits": lambda a, nbits: (a if nbits // 32 >= a.shape[-1] else limbs_cuda.launch(
        "mask_bits", tuple(a.shape), a.shape[-1], a, nbits=nbits)),
    "rshift_round": lambda a, t, k_out: limbs_cuda.launch(
        "rshift_round", tuple(a.shape[:-1]) + (k_out,), a.shape[-1], a, k_out=k_out, t=t),
    "rshift_round_mask": lambda a, t, nbits, k_out: limbs_cuda.launch(
        "rshift_round_mask", tuple(a.shape[:-1]) + (k_out,), a.shape[-1], a, k_out=k_out, t=t,
        nbits=nbits),
    "from_digits16": lambda d, k_out: limbs_cuda.launch(
        "from_digits16", tuple(d.shape[:-1]) + (k_out,), d.shape[-1], d, k_out=k_out, digits=True),
}


def _row_kernel(op, *args):
    """(output, how it ran) of one launch of K7's `op`, the lift for "_lift",
    on CPU tensors: the wrapper's argument handling, then the numpy model of
    the kernel in place of the library.  How it ran: "word" (the word
    kernel), "warp" (a warp per row group, one chunk) or "chunks" (a row of
    more than 32 limbs, the warp 32 limbs at a time)."""
    def how(plan):
        return plan["design"] if plan["design"] == "word" or plan["chunks"] == 1 else "chunks"
    if op == "_lift":
        out, plan = rt.run_lift(*args)
        return u64_to_torch(out), how(plan)
    seen = []

    def launch(name, out_shape, k, a, b=None, bit=None, k_out=0, t=0, nbits=0, digits=False):
        out, plan = rt.run_limbs(name, out_shape, k, a, b, bit, k_out, t, nbits)
        seen.append(how(plan))
        return torch.from_numpy(out) if out.dtype == bool else u64_to_torch(out)
    real = limbs_cuda.launch
    limbs_cuda.launch = launch
    try:
        out = _CUDA_BRANCH[op](*args)
    finally:
        limbs_cuda.launch = real
    return out, seen[0] if seen else None


def _defines(path):
    return {m[0]: int(m[1]) for m in
            re.findall(r"^#define (\w+) (\d+)", open(path).read(), flags=re.M)}


def test_row_kernel_constants_mirror_the_source():
    """The numpy model holds the constants of rowwarp.cuh, which both
    kernels' sources include, and of the lift's rns.cu; the lift's chunks
    hold rns_cuda.MAX_LIMBS limbs."""
    cuh = os.path.join(cuda_build.CSRC, "rowwarp.cuh")
    d = _defines(cuh)
    assert (d["ROWWARP_THREADS"], d["WARP_GROUPS"]) == (rt.ROWWARP_THREADS, rt.WARP_GROUPS)
    assert _defines(rns_cuda.SOURCE)["MAX_CHUNKS"] == rt.MAX_CHUNKS
    assert 32 * rt.MAX_CHUNKS == rns_cuda.MAX_LIMBS
    for m in (limbs_cuda, rns_cuda):
        assert open(cuh, "rb").read() in cuda_build._with_includes(m.SOURCE)


def _lanes_cover(L):
    """Every limb of a row in exactly one (chunk, lane) of its group, and a
    spare lane after each group of a row below 32 limbs."""
    W = rt.lanes_a_group(L)
    G = 32 // W
    assert G >= 1 and G * W <= 32 and (L >= 32 or W == L + 1)
    limbs = sorted(c0 + i for c0 in range(0, L, 32) for i in range(W) if c0 + i < L)
    assert limbs == list(range(L))


@pytest.mark.parametrize("k", EDGE_K)
def test_row_plans(k):
    """Each chain's launch at K limbs (and K + 1, K - 1 limbs out): a warp per
    row group, W = L + 1 lanes a group below 32 limbs (one spare), the whole
    warp over ceil(L / 32) chunks from 32; EDGE_ROWS rows, the edge cases'
    count, make two full blocks and a partial one at every K."""
    for op in LIMB_OPS:
        if op in ("mask_bits", "select"):
            continue
        for k_out in (k, k + 1, max(1, k - 1)):
            L = rt.chain_limbs(op, k, k_out)
            assert L == (k_out if op == "from_digits16" or k_out > k else k)
            _lanes_cover(L)
            per_block = rt.rows_a_block(L)
            assert EDGE_ROWS > 2 * per_block and EDGE_ROWS % per_block
            assert per_block == 4 * rt.WARP_GROUPS * (32 // rt.lanes_a_group(L))


def test_lift_plans():
    """The lift at 1-128 limbs: NCH chunks of 32 limbs (1, 2 or 4) that hold
    the row, WARP_GROUPS / NCH rows a lane (a lane holds 8 digit sums);
    EDGE_ROWS rows make two full blocks and a partial one at every width."""
    for k in range(1, rns_cuda.MAX_LIMBS + 1):
        nch = rt.lift_chunks(k)
        assert nch in (1, 2, 4) and k <= 32 * nch and (nch == 1 or k > 16 * nch)
        assert rt.lift_rows_a_lane(nch) * nch == rt.WARP_GROUPS     # 8 digit sums a lane
        _lanes_cover(k)
        per_block = rt.rows_a_block(k, rt.lift_rows_a_lane(nch))
        assert EDGE_ROWS > 2 * per_block and EDGE_ROWS % per_block


@functools.lru_cache(maxsize=1)
def _edge_cases():
    return elementwise_edge_cases(torch.device("cpu"))


@pytest.mark.parametrize("entry", [f"limbs_{op}" for op in LIMB_OPS] + ["crt_lift"])
def test_row_kernels_at_tile_edges(entry):
    """chip_smoke.py's edge cases (the card runs the same ones) through the
    numpy model of each launch, against the plain torch version: every K of
    EDGE_K on two full blocks and a partial one, edge rows (a carry and a
    borrow through every limb, equal rows, rows equal but for the top limb),
    constant, broadcast, row-strided and limb-strided operands with two
    leading rows, bool and int64 row bits, the 16-byte pair path and the
    word path of mask_bits and select, the lift at one, two and four chunks
    on f64 and int64 digit sums and estimates past both clamps."""
    cases = [c for c in _edge_cases() if c["entry"] == entry]
    designs = set()
    for case in cases:
        got, design = _row_kernel(case["op"], *case["args"])
        designs.add(design)
        assert torch.equal(got, case["plain"]()), case["shape"]
    want = {"limbs_mask_bits": {"word"}, "limbs_select": {"word"}}.get(entry, {"warp", "chunks"})
    assert designs == want


# ---------------------------------------------------------------------------
# dispatch and argument checks
# ---------------------------------------------------------------------------

def _no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel library was built or loaded")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    for m in (modmath_cuda, rns_cuda, limbs_cuda):
        monkeypatch.setattr(m, "_lib", None)


def test_cpu_tensors_load_no_library(monkeypatch):
    """Every dispatched name on CPU tensors takes its plain version: no
    library is built or loaded, no launch is counted, and a small engine's
    mul_rs, rot and hoisted step run (their programs call the fused entries)."""
    from gpqhe_tpu_torch import CKKS, HeContext, Surf
    from gpqhe_tpu_torch.algo import linalg
    _no_library(monkeypatch)
    counts = [dict(m.LAUNCHES) for m in (modmath_cuda, rns_cuda, limbs_cuda)]
    ctx = HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30, logp=29)
    eng = CKKS(ctx, rng=Surf(), device="cpu")
    pk, sk = eng.keypair()
    rlk, rk = eng.genrlk(sk), eng.genrk(sk)
    ct = eng.enc_pk(eng.ecd(np.arange(4) / 8), pk)
    eng.mul_rs(ct, ct, rlk)
    eng.rot(ct, 1, rk)
    plan = linalg.HoistedGemvPlan(eng, np.eye(4).reshape(-1))
    assert linalg.gemv_hoisted_full(eng, plan, ct, rk) is not None
    x = torch.ones((3, 2, 8), dtype=torch.int64)
    p = torch.full((2, 1), 7, dtype=torch.int64)
    tm.summod(x, p)
    tm.to_mont(x, p, p, p)
    assert [dict(m.LAUNCHES) for m in (modmath_cuda, rns_cuda, limbs_cuda)] == counts


def _imports_from(path, module):
    tree = ast.parse(open(path).read())
    return [a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
            and node.module == module for a in node.names]


def test_ntt_twin_binds_only_plain_modmath():
    """ops/ntt.py (the twin every NTT kernel is held to) must not reach a
    kernel on a CUDA tensor: it imports only plain_ modmath names."""
    from gpqhe_tpu_torch.ops import ntt
    names = _imports_from(ntt.__file__, "modmath")
    assert names and all(n.startswith("plain_") for n in names), names


DISPATCHED = {tm: ["mont_mul", "mulmod", "to_mont", "addmod", "submod", "summod", "cross_terms",
                   "key_products", "mulmod_sum"],
              tr: ["decompose_core", "decompose", "digit_split", "_digit_partials", "_lift"],
              tl: ["add", "sub", "neg", "add_scalar_bit", "select", "geq_const", "mask_bits",
                   "rshift_round", "rshift_round_mask", "from_digits16"]}


@pytest.mark.parametrize("module", [tm, tr, tl], ids=["modmath", "rns", "limbs"])
def test_plain_versions_call_only_plain_versions(module):
    """No plain_* function calls a dispatched name (of its own module or,
    for rns, of limbs and modmath): the plain chains stay pure torch."""
    dispatched = {n for names in DISPATCHED.values() for n in names}
    tree = ast.parse(inspect.getsource(module))
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("plain_"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    f = node.func
                    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                    assert name not in dispatched, (module.__name__, fn.name, name)


def _bad_calls():
    i64 = torch.int64
    x = torch.zeros((3, 16), dtype=i64)
    p = torch.ones((3, 1), dtype=i64)
    limbs = torch.zeros((16, 6), dtype=i64)
    plan = tr.make_recon_plan(CHAINS[59][1], 3, "cpu")
    return {
        "modmath dtype": (lambda: modmath_cuda.elementwise("mulmod", x.int(), x.int(), p, p, p),
                          "int64"),
        "modmath prime axis": (lambda: modmath_cuda.elementwise(
            "mulmod", x, x, torch.ones((4, 1), dtype=i64), p, p), "broadcast"),
        "modmath constant along n": (lambda: modmath_cuda.key_products(x, x, x, x, p, p),
                                     "prime axis"),
        "modmath sum dtype": (lambda: modmath_cuda.sums("mulmod_sum", x[None].double(), x[None],
                                                        (), p, p, p), "int64"),
        "decompose table": (lambda: rns_cuda.decompose(limbs, p[:, 0], p[:, 0],
                                                       torch.zeros((3, 3), dtype=i64).t()),
                            "contiguous"),
        "decompose primes": (lambda: rns_cuda.decompose(limbs, p[:, 0], p[:2, 0],
                                                        torch.zeros((3, 3), dtype=i64)), "primes"),
        "digit_split dtype": (lambda: rns_cuda.digit_split(x.double(), 4, plan.inv_p), "int64"),
        "digit_split primes": (lambda: rns_cuda.digit_split(torch.zeros((4, 16), dtype=i64), 4,
                                                            plan.inv_p), "primes"),
        "lift table": (lambda: rns_cuda.lift(
            torch.zeros((16, 4), dtype=torch.float64), torch.zeros(16, dtype=torch.float64),
            dataclasses.replace(plan, P_limbs=torch.zeros((plan.ks, 2), dtype=i64)[:, 0]),
            True, 2), "contiguous"),
        "lift dtype": (lambda: rns_cuda.lift(torch.zeros((16, 4), dtype=torch.int32),
                                             torch.zeros(16, dtype=torch.float64), plan, True, 2),
                       "digit sums"),
        "limbs dtype": (lambda: limbs_cuda.binary("add", limbs, limbs.double()), "int64"),
        "limbs shape": (lambda: limbs_cuda.binary("add", limbs, limbs[:, :5]), "broadcast"),
        "limbs row operand": (lambda: limbs_cuda.select(torch.zeros(16, dtype=torch.float32),
                                                        limbs, limbs), "row operand"),
        "limbs row width": (lambda: rns_cuda.lift(
            torch.zeros((16, 4), dtype=torch.float64), torch.zeros(16, dtype=torch.float64),
            plan, True, rns_cuda.MAX_LIMBS + 1), "at most 128 limbs"),
        "limbs rows": (lambda: limbs_cuda.binary(
            "add", torch.zeros((1 << 16, 1, 2), dtype=i64), torch.zeros((1 << 15, 2), dtype=i64)),
            "2\\^31"),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrappers_raise_before_loading(monkeypatch, case):
    """Each wrapper checks types, shapes, prime axes and table contiguity
    before it builds or loads a library (and on a CPU tensor, after those,
    refuses the device)."""
    _no_library(monkeypatch)
    fn, words = _bad_calls()[case]
    with pytest.raises(ValueError, match=words):
        fn()


def test_host_constant_caches():
    """mul_const_mod2k uploads its Toeplitz matrix once per (constant, k_in,
    k_out, device), and geq_const's weights once per (width, device)."""
    c16 = np.array([3, 0, 1], dtype=np.uint64)
    a = torch.randint(0, 1 << 32, (4, 5), dtype=torch.int64)
    tl.mul_const_mod2k(a, c16, 5)
    before = tl._toeplitz16_on.cache_info()
    out = tl.mul_const_mod2k(a, c16.copy(), 5)
    after = tl._toeplitz16_on.cache_info()
    assert after.hits == before.hits + 1 and after.misses == before.misses
    vals = bigint.limbs_to_ints(a.numpy().astype(np.uint32))
    assert bigint.limbs_to_ints(out.numpy().astype(np.uint32)) == [
        v * (3 + (1 << 32)) % (1 << 160) for v in vals]
    assert tl._sign_weights(62, torch.device("cpu")) is tl._sign_weights(62, torch.device("cpu"))


@pytest.mark.parametrize("ts,shape,lead", [
    ((3, 16, 8), (2, 3, 16, 8), 0), ((3, 1, 16, 8), (3, 2, 16, 8), 0),
    ((2, 1, 16, 8), (2, 3, 16, 8), 1), ((1, 3, 16, 8), (2, 3, 16, 8), 1),
    ((16, 8), (4, 16, 8), 0), ((2, 3, 1, 16, 8), (2, 3, 4, 16, 8), 1)])
def test_strides3_views_broadcast_operands(ts, shape, lead):
    """The [M, A, rows, cols] strides that strides3 gives the kernels read
    the broadcast operand back whole, also where its broadcast axes do not
    collapse into one and it has to be copied."""
    t = torch.arange(int(np.prod(ts)), dtype=torch.int64).reshape(ts)
    x, sm, sa, sb, sc = cuda_build.strides3(t, shape, lead)
    M = shape[0] if lead else 1
    A = int(np.prod(shape[lead:-2]))
    seen = torch.as_strided(x, (M, A) + shape[-2:], (sm, sa, sb, sc), x.storage_offset())
    assert torch.equal(seen, t.expand(shape).reshape((M, A) + shape[-2:]))


def test_sources_name_their_kernels():
    """The three libraries exist beside the NTT's and share mont.cuh, whose
    bytes their build hash covers."""
    for m in (modmath_cuda, rns_cuda, limbs_cuda):
        assert os.path.exists(m.SOURCE)
    mont = os.path.join(cuda_build.CSRC, "mont.cuh")
    for m in (modmath_cuda, rns_cuda):
        assert open(mont, "rb").read() in cuda_build._with_includes(m.SOURCE)


# ---------------------------------------------------------------------------
# the launch model: which device kernels an op would launch on a card
# ---------------------------------------------------------------------------

# (module, its kernel's name, the dispatched entries that launch one kernel
# each, as their callers reach them)
_ENTRIES = [(tm, "modmath", DISPATCHED[tm]),
            (tr, "rns", ["decompose_core", "digit_split", "_lift"]),
            (tl, "limbs", DISPATCHED[tl])]


def launch_model(fn, plain: bool = False):
    """Run fn on the CPU with every dispatched entry counted as the kernel
    launches it makes on a card (an NTT transform two: its column and row
    passes; a four-step stage one, "ntt4") and every other aten op that
    is not a view counted as one torch kernel; returns {module: launches} with torch's ops by name under
    "other torch".  plain=True models the port before its elementwise
    kernels: each aten op inside a dispatched entry counts as one launch of
    that entry's module (the outermost entry's)."""
    import sys

    from torch.utils._python_dispatch import TorchDispatchMode

    from gpqhe_tpu_torch.ops import ntt4, ntt_cuda, ntt_cuda32
    counts = {"ntt": 0, "ntt4": 0, "modmath": 0, "rns": 0, "limbs": 0, "other torch": {}}
    inside = []                       # the modules of the entries being run

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            aliases = any(r.alias_info is not None for r in func._schema.returns)
            view = aliases or name in ("_unsafe_view", "lift_fresh") or name.startswith("empty")
            if view:
                return out
            if not inside:
                counts["other torch"][name] = counts["other torch"].get(name, 0) + 1
            elif plain and inside[0] != "ntt":
                counts[inside[0]] += 1
            return out

    def counted(fn, module, launches):
        def wrapper(*a, **k):
            if not inside and (module == "ntt" or not plain):
                counts[module] += launches
            inside.append(module)
            try:
                return fn(*a, **k)
            finally:
                inside.pop()
        return wrapper
    patches = []
    for mod, kernel, names in _ENTRIES:
        for name in names:
            patches.append((mod, name, counted(getattr(mod, name), kernel, 1)))
    for m in (ntt_cuda, ntt_cuda32):
        patches += [(m, "ntt", counted(m.ntt, "ntt", 2)), (m, "intt", counted(m.intt, "ntt", 2))]
    # the four-step NTT: a stage (the plain split, torch.bmm and combine) is
    # one K8 launch
    patches.append((ntt4, "plain_ntt4_stage", counted(ntt4.plain_ntt4_stage, "ntt4", 1)))
    # names bound by `from ... import` in the programs
    for modname in ("gpqhe_tpu_torch.scheme.engine", "gpqhe_tpu_torch.ring.poly",
                    "gpqhe_tpu_torch.parallel.mesh"):
        mod = importlib.import_module(modname)
        for name in DISPATCHED[tm]:
            if hasattr(mod, name):
                patches.append((mod, name, counted(getattr(tm, name), "modmath", 1)))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, f in patches:
            setattr(m, n, f)
        with Count():
            fn()
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    return counts


def test_launch_model_of_the_main_path():
    """On a card, mul_rs and rot go through the kernels with few torch
    launches beside them: the dispatch covers every elementwise chain of
    the programs (a chain left in plain torch would add hundreds)."""
    from gpqhe_tpu_torch import CKKS, HeContext, Surf
    import gpqhe_tpu_torch.parallel.mesh  # noqa: F401  (its names are patched too)
    ctx = HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf(), device="cpu")
    pk, sk = eng.keypair()
    rlk, rk = eng.genrlk(sk), eng.genrk(sk)
    ct = eng.enc_pk(eng.ecd(np.arange(4) / 8), pk)
    eng.mul_rs(ct, ct, rlk)
    eng.rot(ct, 1, rk)                        # programs built outside the count
    mul = launch_model(lambda: eng.mul_rs(ct, ct, rlk))
    rot = launch_model(lambda: eng.rot(ct, 1, rk))
    # mul_rs: 2 decomposes (the 4 polys in one, then d2), 3 reconstructs
    # (digit_split + lift each: the 3 products in one, the key switch's c and
    # r of both halves), the cross terms and key products, the limb steps of
    # one divide-round of both halves and the rescale; 4 NTT launches of 2
    # passes; beside them the inputs' stack, the digit matmuls and the cast
    # of the key switch (from 5 decomposes, 7 reconstructs, 19 limb and 18
    # torch launches when each poly and half went alone: 66 launches -> 39)
    assert mul["ntt"] == 8 and mul["rns"] == 2 + 2 * 3 and mul["modmath"] == 2
    assert mul["limbs"] == 12 and sum(mul["other torch"].values()) == 9, mul
    # rot: 1 decompose, 2 reconstructs (from 4), 13 limb and 11 torch
    # launches (from 18 and 18: 50 -> 34)
    assert rot["ntt"] == 4 and rot["rns"] == 1 + 2 * 2 and rot["modmath"] == 1
    assert rot["limbs"] == 13 and sum(rot["other torch"].values()) == 11, rot
    # before the kernels: the same program's chains, launch by launch
    before = launch_model(lambda: eng.mul_rs(ct, ct, rlk), plain=True)
    assert before["ntt"] == 8 and before["other torch"] == mul["other torch"]
    assert before["rns"] > 50 * mul["rns"] and before["modmath"] > 100 * mul["modmath"]


def test_launch_model_of_mul_rs_on_the_matmul_backend():
    """mul_rs with ntt_impl="matmul": each of its four transforms is two K8
    stage launches (split, digit GEMM and combine in one) in place of one
    butterfly launch of two passes; every other launch is the butterfly
    engine's."""
    from gpqhe_tpu_torch import CKKS, HeContext, Surf
    ctx = HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30)
    got = {}
    for impl in ("butterfly", "matmul"):
        eng = CKKS(ctx, rng=Surf(), device="cpu", ntt_impl=impl)
        pk, sk = eng.keypair()
        rlk = eng.genrlk(sk)
        ct = eng.enc_pk(eng.ecd(np.arange(4) / 8), pk)
        eng.mul_rs(ct, ct, rlk)                   # programs built outside the count
        got[impl] = launch_model(lambda: eng.mul_rs(ct, ct, rlk))
    bf, mm = got["butterfly"], got["matmul"]
    assert bf["ntt"] == 8 and bf["ntt4"] == 0
    # 16 K8 launches (split + combine) and 8 torch.bmm before the fused stage
    assert mm["ntt"] == 0 and mm["ntt4"] == 4 * 2
    # no digit GEMM left in torch: the reconstructs' digit matmuls are the
    # only bmm launches, on both backends
    assert mm["other torch"] == bf["other torch"]
    assert all(mm[k] == bf[k] for k in ("rns", "modmath", "limbs"))
    # 39 launches on both backends (55 on matmul before the fused stage)
    total = {k: sum(v[m] for m in ("ntt", "ntt4", "rns", "modmath", "limbs"))
             + sum(v["other torch"].values()) for k, v in got.items()}
    assert total == {"butterfly": 39, "matmul": 39}, total


def test_launch_model_counts_a_plain_mulmod():
    """One plain mulmod is 118 torch launches (two Montgomery products of
    59): what a CUDA mulmod launch replaces."""
    x = torch.ones((3, 8), dtype=torch.int64)
    p = torch.full((3, 1), 97, dtype=torch.int64)
    got = launch_model(lambda: tm.mulmod(x, x, p, p, p), plain=True)
    assert got["modmath"] == 118 and not got["other torch"], got
