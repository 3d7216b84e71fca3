"""ops/modmath.py in torch is bit-equal to the JAX package's jnp functions.

Inputs are u64 words made with numpy from a seed: random residues below
every prime of the default 59-bit chain (and of a logp=29 chain), the edge
values 0, 1 and p-1, and, where the function admits a full 64-bit operand,
2^63-1, 2^63 and 2^64-1.  The port stores u64 words in int64 with the same
bit patterns, so equality is checked on the raw words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext
from gpqhe_tpu.ops import modmath as jm

from gpqhe_tpu_torch.ops import modmath as tm

torch.set_num_threads(1)

FULL_EDGES = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], dtype=np.uint64)
CHAINS = {59: PolyContext(11, 1 << 54, dim_cap=8), 29: PolyContext(11, 1 << 54, logp=29, dim_cap=4)}


def _residues(rng, p, size=512):
    r = rng.integers(0, p, size, dtype=np.uint64)
    return np.concatenate([r, np.array([0, 1, p - 1], dtype=np.uint64)])


def _full(rng, size):
    r = rng.integers(0, 2**64 - 1, size, dtype=np.uint64, endpoint=True)
    return np.concatenate([r, FULL_EDGES])


def _t(x):
    return tm.u64_to_torch(x)


def _eq(jout, tout):
    return np.array_equal(np.asarray(jout), tm.torch_to_u64(tout))


FNS = ["mulhilo64", "mont_reduce", "mont_mul", "mulmod", "to_mont", "addmod", "submod"]


@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("fn", FNS)
def test_bit_equal_to_jnp(fn, logp):
    pctx = CHAINS[logp]
    rng = np.random.default_rng(100 * logp + FNS.index(fn))
    for i, p in enumerate(pctx.primes):
        pc = pctx.prime_ctx[i]
        ju = lambda v: jnp.asarray(np.array(v, dtype=np.uint64))  # noqa: E731
        P, PINV, R2 = (np.array(v, dtype=np.uint64) for v in (p, pc.pinv_mont, pc.r2))
        if fn == "mulhilo64":
            a, b = _full(rng, 515), _full(rng, 515)[::-1].copy()
            jh, jl = jm.mulhilo64(jnp.asarray(a), jnp.asarray(b))
            th, tl = tm.mulhilo64(_t(a), _t(b))
            assert _eq(jh, th) and _eq(jl, tl), p
            continue
        if fn == "mont_reduce":          # admits hi < p, any lo
            hi, lo = _residues(rng, p), _full(rng, 510)
            args = (hi, lo, P, PINV)
        elif fn in ("mont_mul", "mulmod"):  # a any u64, b < p
            args = (_full(rng, 510), _residues(rng, p), P, PINV) + ((R2,) if fn == "mulmod" else ())
        elif fn == "to_mont":
            args = (_full(rng, 510), P, PINV, R2)
        else:                            # addmod / submod: a, b < p
            a = _residues(rng, p)
            args = (a, _residues(rng, p)[::-1].copy(), P)
        jout = getattr(jm, fn)(*(ju(x) for x in args))
        tout = getattr(tm, fn)(*(_t(x) for x in args))
        assert _eq(jout, tout), (fn, p)


def test_u64_roundtrip_keeps_bit_patterns():
    x = _full(np.random.default_rng(3), 64)
    t = tm.u64_to_torch(x)
    assert t.dtype == torch.int64
    assert np.array_equal(tm.torch_to_u64(t), x)


def test_barrett_inv_equals_the_original():
    for p in CHAINS[59].primes + CHAINS[29].primes + [3, (1 << 61) - 1]:
        assert tm.barrett_inv(p) == jm.barrett_inv(p) == (1 << (2 * p.bit_length())) // p


@pytest.mark.parametrize("i", range(4))
def test_barrett_reduce_bit_equal_to_jnp(i):
    """128-bit products of residues (0, 1, p-1 among them) of a 60-bit prime
    (2 * qbits >= 64, as the function requires): equal to jnp's words and to
    the Python-integer remainder; and on arbitrary words, where the value is
    out of the function's range, still equal to jnp's, word for word (the
    128-bit carry and the last compare are unsigned)."""
    p = CHAINS[59].primes[i]
    rng = np.random.default_rng(7 + i)
    a, b = _residues(rng, p), _residues(rng, p)[::-1].copy()
    prod = [int(x) * int(y) for x, y in zip(a, b)]
    hi = np.array([v >> 64 for v in prod], dtype=np.uint64)
    lo = np.array([v & (2**64 - 1) for v in prod], dtype=np.uint64)
    q, qinv = (np.array(v, dtype=np.uint64) for v in (p, tm.barrett_inv(p)))
    qbits = p.bit_length()
    for h, l in ((hi, lo), (_full(rng, 510), _full(rng, 510)[::-1].copy())):
        jout = jm.barrett_reduce(jnp.asarray(h), jnp.asarray(l), jnp.asarray(q),
                                 jnp.asarray(qinv), qbits)
        tout = tm.barrett_reduce(_t(h), _t(l), _t(q), _t(qinv), qbits)
        assert _eq(jout, tout), p
    got = tm.torch_to_u64(tm.barrett_reduce(_t(hi), _t(lo), _t(q), _t(qinv), qbits))
    assert [int(v) for v in got] == [v % p for v in prod]
