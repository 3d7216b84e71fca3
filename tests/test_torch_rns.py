"""ops/rns.py in torch is bit-equal to the JAX package's decompose and CRT
reconstruct.

Decompose takes random limb polys (odd and even limb counts, with and
without a batch axis, all-0xFFFFFFFF rows).  Reconstruct takes the residues
of random integers of known size: the exact full-width path with center
True and False, the truncated k_out fast path under its magnitude margin,
and pre_scaled inputs (residues already multiplied by phat^-1, as the
scaled inverse NTT emits them).  The results are exact integers, so they
must agree bit for bit although the port sums S with 16-bit digits in f64
and the JAX package with 8-bit bf16 planes, and the f64 alpha estimate is
summed in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import rns as jr
from gpqhe_tpu.ops.modmath import mont_mul as jmont_mul
from gpqhe_tpu.substrate import bigint

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import rns as tr
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch

torch.set_num_threads(1)

LOGN, DIMCAP = 11, 8
N = 1 << LOGN


@pytest.fixture(scope="module")
def ctxs():
    return (JPolyContext(LOGN, q=1 << 54, dim_cap=DIMCAP),
            PolyContext(LOGN, q=1 << 54, dim_cap=DIMCAP))


def _limbs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    a[..., 0, :] = 0xFFFFFFFF
    a[..., 1, :] = 0
    return a


@pytest.mark.parametrize("dim", [3, 8])
@pytest.mark.parametrize("shape", [(N, 2), (N, 3), (N, 14), (2, N, 7)])
def test_decompose(ctxs, dim, shape):
    jp, tp = ctxs
    a = _limbs(shape, dim * 100 + shape[-1])
    k = shape[-1]
    jba = jr.make_basis_arrays(jp, dim)
    want = np.asarray(jax.jit(lambda x: jr.decompose(x, jba, jr.make_decomp_weights(jp, dim, k)))(
        jnp.asarray(a)))
    tba = tr.make_basis_arrays(tp, dim, "cpu")
    w = u64_to_torch(tr.make_decomp_weights(tp, dim, k))
    got = tr.decompose(torch.from_numpy(a.astype(np.int64)), tba, w)
    assert np.array_equal(want, torch_to_u64(got))


def _residues(values, primes):
    """[..., n] python ints -> u64[..., dim, n] residues."""
    v = np.asarray(values, dtype=object)
    return np.stack([(v % p).astype(np.uint64) for p in primes], axis=-2)


def _values(rng, shape, lo, hi):
    """Random python ints in [lo, hi)."""
    span = hi - lo
    words = (span.bit_length() + 63) // 64 + 1
    raw = rng.integers(0, 1 << 63, shape + (words,), dtype=np.int64)
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        x = 0
        for w in raw[idx]:
            x = (x << 63) | int(w)
        out[idx] = lo + x % span
    return out


CASES = {
    # name: (center, k_out, bound margin bits below logP, pre_scaled)
    "center_full": (True, None, 1, False),
    "nonneg_full": (False, None, 0, False),
    "center_fast": (True, "k", 4, False),
    "center_fast_prescaled": (True, "k", 4, True),
    "nonneg_prescaled": (False, None, 0, True),
}


@pytest.mark.parametrize("dim", [3, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_reconstruct(ctxs, dim, case):
    jp, tp = ctxs
    center, k_out, margin, pre_scaled = CASES[case]
    b = jp.basis(dim)
    P = b.P
    rng = np.random.default_rng(dim * 10 + list(CASES).index(case))
    bound_bits = P.bit_length() - margin
    if center:
        vals = _values(rng, (2, N), -(1 << (bound_bits - 1)), 1 << (bound_bits - 1))
    else:
        vals = _values(rng, (2, N), 0, P)
    vals[0, :4] = [0, 1, -1 if center else P - 1, (P // 2) if not center else 0]
    res = _residues(vals, b.primes)                       # u64[2, dim, n]
    jba = jr.make_basis_arrays(jp, dim)
    plan = jr.make_recon_plan(jp, dim)
    if pre_scaled:
        res = np.asarray(jax.jit(jmont_mul)(jnp.asarray(res), jba.phatinv_mont[:, None],
                                            jba.ps[:, None], jba.pinv[:, None]))
    kw = dict(center=center, pre_scaled=pre_scaled)
    if k_out == "k":
        kw.update(k_out=plan.ks - 2, bound_bits=bound_bits)
    want = np.asarray(jax.jit(functools.partial(jr.reconstruct, ba=jba, plan=plan, **kw))(
        jnp.asarray(res)))
    tba = tr.make_basis_arrays(tp, dim, "cpu")
    tplan = tr.make_recon_plan(tp, dim, "cpu")
    got = tr.reconstruct(u64_to_torch(res), tba, tplan, **kw).numpy()
    assert np.array_equal(want.astype(np.int64), got)
    # and both are the exact integers (mod the output width)
    kk = got.shape[-1]
    exp = bigint.ints_to_limbs([int(v) for v in vals.reshape(-1)], kk)
    assert np.array_equal(got.reshape(-1, kk), exp.astype(np.int64))


def test_recon_plan_matches_jax(ctxs):
    jp, tp = ctxs
    for dim in (1, 3, 8):
        a, b = jr.make_recon_plan(jp, dim), tr.make_recon_plan(tp, dim, "cpu")
        for f in ("dim", "ds", "ks", "logP"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("negP16", "P_limbs", "Phalf_limbs", "MminusP_limbs", "inv_p"):
            assert np.array_equal(getattr(a, f), getattr(b, f).numpy()), f
        assert np.array_equal(tr.phat_digit_table(a.phat16, b.nd), b.phat_digits.numpy())


# -- tests/test_ops.py's edge values, on its ring (logn=6, 60-bit primes) --------

EDGE_LOGN = 6


@pytest.fixture(scope="module")
def edge_ctxs():
    return (JPolyContext(EDGE_LOGN, q=1 << 20, dim_cap=24),
            PolyContext(EDGE_LOGN, q=1 << 20, dim_cap=24))


def _edge(vals, n):
    return (vals * (n // len(vals) + 1))[:n]


def _plans(ctxs, dim):
    jp, tp = ctxs
    return (jr.make_basis_arrays(jp, dim), jr.make_recon_plan(jp, dim),
            tr.make_basis_arrays(tp, dim, "cpu"), tr.make_recon_plan(tp, dim, "cpu"))


def _both(res, jba, jplan, tba, tplan, **kw):
    want = np.asarray(jax.jit(functools.partial(jr.reconstruct, ba=jba, plan=jplan, **kw))(
        jnp.asarray(res)))
    got = tr.reconstruct(u64_to_torch(res), tba, tplan, **kw).numpy()
    assert np.array_equal(want.astype(np.int64), got)
    return got


@pytest.mark.parametrize("dim", [2, 8])
def test_reconstruct_boundary_values(edge_ctxs, dim):
    """Values next to 0, +-2^bound_bits and P (test_ops.py:152): the fast
    truncated path, the exact centered path and center=False, each against
    Python integers and the JAX package."""
    jba, jplan, tba, tplan = _plans(edge_ctxs, dim)
    b = edge_ctxs[1].basis(dim)
    bound_bits = tplan.logP - 40
    big = (1 << bound_bits) - 1
    vals = _edge([0, 1, 2, -1, -2, big, -big, big - 1, -(big - 1), 3, -3], 1 << EDGE_LOGN)
    res = _residues(vals, b.primes)
    k_out = max(2, (bound_bits + 63) // 32)
    assert k_out < tplan.ks
    fast = _both(res, jba, jplan, tba, tplan, center=True, k_out=k_out, bound_bits=bound_bits)
    exact = _both(res, jba, jplan, tba, tplan, center=True)
    nonneg = _both(res, jba, jplan, tba, tplan, center=False, k_out=tplan.ks)
    mod_f = 1 << (32 * k_out)
    assert bigint.limbs_to_ints(fast) == [v % mod_f for v in vals]
    assert bigint.limbs_to_signed_ints(exact) == vals
    assert bigint.limbs_to_ints(nonneg) == [v % b.P for v in vals]


def test_reconstruct_fast_path_alpha_stress(edge_ctxs):
    """inv_p times (1 + 2^-22) on both packages' plans (test_ops.py:195): the
    f64 alpha estimate misses floor(S/P) for near-boundary values, and the
    centered fast path must still be exact."""
    import dataclasses
    dim = 8
    jba, jplan, tba, tplan = _plans(edge_ctxs, dim)
    jplan = dataclasses.replace(jplan, inv_p=jplan.inv_p * (1.0 + np.float64(2.0 ** -22)))
    tplan = dataclasses.replace(tplan, inv_p=tplan.inv_p * (1.0 + 2.0 ** -22))
    assert np.array_equal(np.asarray(jplan.inv_p), tplan.inv_p.numpy())
    b = edge_ctxs[1].basis(dim)
    bound_bits = tplan.logP - 40
    big = (1 << bound_bits) - 1
    vals = _edge([0, 1, -1, big, -big, 12345, -12345], 1 << EDGE_LOGN)
    k_out = max(2, (bound_bits + 63) // 32)
    fast = _both(_residues(vals, b.primes), jba, jplan, tba, tplan, center=True, k_out=k_out,
                 bound_bits=bound_bits)
    assert bigint.limbs_to_ints(fast) == [v % (1 << (32 * k_out)) for v in vals]
