"""ops/limbs.py in torch is bit-equal to the JAX package's jnp limb ops.

Inputs are u32 limb tensors made with numpy from a seed: random limbs,
all-0xFFFFFFFF carry chains, all-zero borrow chains, and rows that differ
only in one limb.  Widths cover the main path's (1, 2, 7, 14 limbs) and a
65-limb operand for geq_const's hierarchical fold.  The JAX ops run under
jax.jit with their static arguments closed over.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.ops import limbs as jl
from gpqhe_tpu.substrate import bigint

from gpqhe_tpu_torch.ops import limbs as tl

torch.set_num_threads(1)

WIDTHS = [1, 2, 7, 14, 65]
M32 = 0xFFFFFFFF


def _limbs(k, seed, rows=64):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, (rows, k), dtype=np.uint64).astype(np.uint32)
    a[0] = M32                      # full carry chain
    a[1] = 0
    a[2, :] = M32
    a[2, 0] = 0xFFFFFFFE            # chain broken at limb 0
    a[3, :-1] = M32                 # chain ending below the top limb
    a[3, -1] = 0
    a[4] = np.arange(k, dtype=np.uint32)
    return a


def _pair(k, seed):
    a, b = _limbs(k, seed), _limbs(k, seed + 1000)
    b[0] = 1                        # 0xFF..FF + 1 ripples through every limb
    b[1] = M32                      # 0 - 0xFF..FF borrows through every limb
    b[5] = a[5]                     # equal rows
    b[6] = a[6]
    b[6, -1] ^= 1                   # equal except the top limb
    return a, b


def _j(fn, *args, **static):
    return np.asarray(jax.jit(functools.partial(fn, **static))(
        *(jnp.asarray(x) for x in args)))


def _t(fn, *args, **static):
    def conv(x):
        x = np.asarray(x)
        return torch.from_numpy(x if x.dtype == bool else x.astype(np.int64))
    return fn(*(conv(x) for x in args), **static).numpy()


def _eq(jout, tout):
    """Equal limbs; the port's int64 limbs must lie in [0, 2^32)."""
    assert tout.min() >= 0 and tout.max() <= M32
    return np.array_equal(np.asarray(jout).astype(np.int64), tout)


@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub(op, k):
    a, b = _pair(k, k)
    assert _eq(_j(getattr(jl, op), a, b), _t(getattr(tl, op), a, b))


@pytest.mark.parametrize("k", WIDTHS)
def test_neg_and_add_scalar_bit(k):
    a = _limbs(k, 2 * k)
    bit = (np.arange(a.shape[0]) % 3 == 0).astype(np.uint32)
    bit[0] = 1
    assert _eq(_j(jl.neg, a), _t(tl.neg, a))
    assert _eq(_j(jl.add_scalar_bit, a, bit), _t(tl.add_scalar_bit, a, bit))


@pytest.mark.parametrize("k", WIDTHS)
def test_select_and_geq_const(k):
    a, b = _pair(k, 3 * k)
    mask = np.arange(a.shape[0]) % 2 == 0
    assert _eq(_j(jl.select, mask, a, b), _t(tl.select, mask, a, b))
    for c in (b[0], b[5], a[6], np.zeros(k, np.uint32), np.full(k, M32, np.uint32)):
        assert np.array_equal(_j(jl.geq_const, a, c), _t(tl.geq_const, a, c))


@pytest.mark.parametrize("k", [1, 2, 7, 14])
def test_mask_resize_fit(k):
    a = _limbs(k, 4 * k)
    a[7, -1] |= 0x80000000          # a negative two's-complement row
    for nbits in sorted({1, 31, 32, 33, 17 * k, 32 * k, 32 * k + 5}):
        assert _eq(_j(jl.mask_bits, a, nbits=nbits), _t(tl.mask_bits, a, nbits=nbits))
    for k_out in sorted({1, k, k + 3}):
        assert _eq(_j(jl.resize, a, k_out=k_out), _t(tl.resize, a, k_out=k_out))
        for bits in sorted({20, 32 * k, 32 * k_out}):
            assert _eq(_j(jl.fit_signed, a, mask_to_bits=bits, k_out=k_out),
                       _t(tl.fit_signed, a, mask_to_bits=bits, k_out=k_out))


@pytest.mark.parametrize("k", [2, 7, 14])
def test_rshift_round(k):
    a = _limbs(k, 5 * k)
    a[8] = 0
    a[8, 1] = 1 << 17               # remainder exactly 2^(t-1) at t=50: ties round down
    a[9] = a[8]
    a[9, 0] = 1                     # just above the tie: rounds up
    for t in sorted({0, 1, 31, 32, 50, 32 * k - 1}):
        for k_out in (None, max(1, k - 2)):
            assert _eq(_j(jl.rshift_round, a, t=t, k_out=k_out),
                       _t(tl.rshift_round, a, t=t, k_out=k_out))


@pytest.mark.parametrize("k_out", [1, 7, 14])
def test_from_digits16(k_out):
    rng = np.random.default_rng(k_out)
    d = rng.integers(0, 1 << 48, (64, 2 * k_out + 3), dtype=np.uint64)
    d[0] = 0xFFFF                   # every digit propagates
    d[0, 0] = 0x10000               # ... a carry generated at the bottom
    d[1] = (1 << 48) - 1
    assert _eq(_j(jl.from_digits16, d, k_out=k_out),
               _t(tl.from_digits16, d.astype(np.int64), k_out=k_out))


@pytest.mark.parametrize("k,k_out", [(2, 2), (14, 14), (7, 14)])
def test_mul_const_mod2k(k, k_out):
    a = _limbs(k, 6 * k)
    for c in ((1 << (32 * k_out)) - 1, pow(3, -1, 1 << (32 * k_out)), 12345):
        c16 = bigint.digits16(c, 2 * k_out)
        assert _eq(_j(jl.mul_const_mod2k, a, c16=c16, k_out=k_out),
                   _t(tl.mul_const_mod2k, a, c16=c16, k_out=k_out))
        want = [(v * c) % (1 << (32 * k_out)) for v in bigint.limbs_to_ints(a)]
        assert np.array_equal(_t(tl.mul_const_mod2k, a, c16=c16, k_out=k_out),
                              bigint.ints_to_limbs(want, k_out).astype(np.int64))


@pytest.mark.parametrize("k", [1, 2, 7, 14])
def test_to_f64_centered(k):
    """Equal f64, value for value: rows with the top bit of the window set
    (negative), the most negative value, -1, zero, and small values that are
    exact in f64."""
    a = _limbs(k, 9 * k)
    a[5] = 0
    a[5, 0] = 12345                 # exact in f64
    a[6] = 0
    for q_bits in sorted({1, 31, 32, 32 * k - 1, 32 * k}):
        hb_limb, hb_bit = divmod(q_bits - 1, 32)
        a[7] = 0
        a[7, hb_limb] = 1 << hb_bit     # -2^(q_bits-1)
        jout = _j(jl.to_f64_centered, a, q_bits=q_bits)
        tout = _t(tl.to_f64_centered, a, q_bits=q_bits)
        assert tout.dtype == np.float64 and np.array_equal(jout, tout)
        assert tout[0] == -1.0 and tout[6] == 0.0 and tout[7] == -float(2 ** (q_bits - 1))
        if q_bits > 15:
            assert tout[5] == 12345.0


@pytest.mark.parametrize("k", [3, 62, 63, 68, 124, 125])
def test_geq_const_wide_bases(k):
    """test_ops.py:227: widths around the 62-limb single-round boundary of
    geq_const's fold (the logn=15 key switch reaches K=68), against Python
    integers and the JAX package."""
    rng = np.random.default_rng(7 + k)
    c_int = int.from_bytes(rng.bytes(4 * k), "little")
    vals = [0, 1, c_int - 1, c_int, c_int + 1, (1 << (32 * k)) - 1] + \
        [int.from_bytes(rng.bytes(4 * k), "little") for _ in range(24)]
    a = bigint.ints_to_limbs(vals, k)
    c = bigint.int_to_limbs(c_int, k)
    got = _t(tl.geq_const, a, c)
    assert np.array_equal(got, np.array([v >= c_int for v in vals]))
    assert np.array_equal(_j(jl.geq_const, a, c), got)
