"""The plain reference (gpubench/reference/) against the port at small
rings on the CPU: its decryption equals the port's exactly, its decode
agrees, and through a whole run the outputs of every request kind agree with
the plaintext circuit."""

import numpy as np
import pytest

from gpubench import harness
from gpubench.reference import ckks
from gpubench.tests import tiny


@pytest.mark.parametrize("kind", sorted(tiny.TINY))
def test_a_run_is_correct_against_the_plaintext_circuit(kind):
    r = tiny.run(tiny.cell(kind))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["judged_outputs"]["value"] >= 1
    assert r["checks"]["max_err"]["value"] < tiny.TINY[kind][2]


@pytest.mark.parametrize("logn, logq, logdelta, slots", [(9, 120, 30, 4), (10, 27, 20, 8),
                                                        (6, 400, 30, 2)])
def test_decrypt_and_decode_equal_the_ports(logn, logq, logdelta, slots):
    from gpubench import port
    cfg = dict(logn=logn, logq=logq, slots=slots, logDelta=logdelta, logp=59, h=64,
               ntt_impl="butterfly")
    rng = np.random.default_rng(logn)
    eng = port.engine(cfg, 5, "cpu")
    s = ckks.secret_key(1 << logn, 64, rng)
    sk = port.secret_key(eng, s)
    m = rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    ct = port.encrypt(eng, sk, m)
    pt = eng.dec(ct, sk)
    n = 1 << logn
    gap = (n // 2) // slots
    pos = np.concatenate([np.arange(slots) * gap, n // 2 + np.arange(slots) * gap])
    mine = ckks.decrypt_coeffs(harness.host_copy(ct)["c0"], harness.host_copy(ct)["c1"], s,
                               ckks.level_bits(cfg, ct.l), pos)
    theirs = eng._poly_to_ints_signed(pt.m, pt.mod_bits)
    assert mine == [theirs[p] for p in pos]
    np.testing.assert_allclose(tiny.decrypt(ct, s, cfg), eng.dcd(pt), rtol=0, atol=1e-12)


def test_secret_key_is_sparse_ternary():
    s = ckks.secret_key(1 << 15, 64, np.random.default_rng(3))
    assert np.count_nonzero(s) == 64 and set(np.unique(s)) == {-1, 0, 1}
    assert np.count_nonzero(ckks.secret_key(16, 64, np.random.default_rng(3))) == 8


def test_same_seed_same_inputs():
    c = harness.Cell.load("n14.gemv_sq")
    a = c.reference.inputs(c.cfg, c.traffic, np.random.default_rng(2**33 + 5))
    b = c.reference.inputs(c.cfg, c.traffic, np.random.default_rng(2**33 + 5))
    assert all(np.array_equal(a[k], b[k]) for k in a)
