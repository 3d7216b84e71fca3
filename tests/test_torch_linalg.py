"""The port's algo/linalg.py against the JAX package's, bit for bit.

Two rings, so that both prime chains run every gemv route:
  logp29: logn=11/logq=48/slots=4/Delta=2^22 on the logp=29 chain (8 switch-
          key primes: room for the hoisting basis), in this file;
  logp59: logn=9/logq=120/slots=4/Delta=2^30 on the default 59-bit chain, in
          test_torch_linalg59.py (building the JAX programs is slow, so the
          two rings run as separate files).  At logn=11/logq=48 that chain
          has only 4 primes, none to spare for hoisting: that ring is the
          fallback case below.
Both engines draw from the same Surf() stream and take the matrix and the
message from one numpy seed; the JAX engine runs its butterfly backend with
its programs jitted as they are, the port its plain CPU twin.  gemv classic,
gemv_hoisted_full, BSGS gemv_hoisted (bank restricted so the full route
returns None), he_sum, he_idx and he_nrm2 give bit-equal ciphertexts
(tolerance 0) and decodes within the noise budget of the plaintext result.
The fallback to the classic path warns and counts once, as in the JAX
package.
"""

import warnings

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.algo import linalg as jlin
from gpqhe_tpu.substrate import surf as jsurf

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.algo import linalg as tlin
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
from gpqhe_tpu_torch.substrate import surf as tsurf

torch.set_num_threads(1)

# ring -> (context arguments, decode tolerance against the plaintext result,
# entries whose decode is compared with it).  logq=48 at Delta=2^22 has two
# levels: he_nrm2 (mul + rs, then the gemv's rs) ends at q_0 = 2^4, below the
# message, so there only its bits and its decode in both packages are compared
ALL = ["classic", "full", "via_gemv", "bsgs", "sum", "sum_hoisted", "idx", "nrm2"]
RINGS = {
    "logp29": (dict(logn=11, q=1 << 48, slots=4, Delta=1 << 22, logp=29), 2e-3, ALL[:-1]),
    "logp59": (dict(logn=9, q=1 << 120, slots=4, Delta=1 << 30, logp=59), 1e-5, ALL),
}
SLOTS = 4


def _inputs():
    rng = np.random.default_rng(31)
    A = rng.random(SLOTS * SLOTS) + 1j * rng.random(SLOTS * SLOTS)
    m = rng.random(SLOTS) + 1j * rng.random(SLOTS)
    return A, m


def _run(pkg, lin, surf, ring_kw, **kw):
    ctx = pkg.HeContext(**ring_kw)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    A, m = _inputs()
    ct = eng.enc_pk(eng.ecd(m), pk)
    out = dict(eng=eng, sk=sk, A=A, m=m)
    out["classic"] = lin.gemv(eng, A, ct, rk)
    plan = lin.HoistedGemvPlan(eng, A)
    out["full"] = lin.gemv_hoisted_full(eng, plan, ct, rk)
    out["via_gemv"] = lin.gemv(eng, None, ct, rk, plan=plan, hoisted=True)
    # the BSGS route needs only the baby steps and the giant-step multiples
    bank = {r: rk[r] for r in rk if r < plan.n1 or r % plan.n1 == 0}
    assert len(bank) < len(rk)
    out["full_none"] = lin.gemv_hoisted_full(eng, plan, ct, bank)
    out["bsgs"] = lin.gemv_hoisted(eng, plan, ct, bank)
    out["fallbacks"] = plan.fallbacks
    out["dims"] = plan.dims(eng, ct.l)
    out["sum"] = lin.he_sum(eng, ct, rk)
    out["sum_hoisted"] = lin.he_sum(eng, ct, rk, hoisted=True)
    out["idx"] = lin.he_idx(eng, ct, 2, rk)
    out["nrm2"] = lin.he_nrm2(eng, ct, rlk, ck, rk)
    return out


def both_runs(ring: str):
    ring_kw, tol, decoded = RINGS[ring]
    return (_run(gpqhe_tpu, jlin, jsurf, ring_kw),
            _run(gt, tlin, tsurf, ring_kw, device="cpu"), tol, decoded)


@pytest.fixture(scope="module")
def runs():
    return both_runs("logp29")


def _expected(name, A, m):
    A2 = A.reshape(SLOTS, SLOTS)
    if name in ("classic", "full", "via_gemv", "bsgs"):
        return A2 @ m
    if name in ("sum", "sum_hoisted"):
        return np.full(SLOTS, m.sum())
    if name == "idx":
        e = np.zeros(SLOTS, dtype=complex)
        e[2] = m[2]
        return e
    return np.full(SLOTS, np.sum(m * np.conj(m)))


def check_bit_equal(runs, name):
    j, t, tol, decoded = runs
    a, b = j[name], t[name]
    assert (a.l, a.nu, a.B) == (b.l, b.nu, b.B)
    assert np.array_equal(np.asarray(a.c0), limbs_to_numpy(b.c0))
    assert np.array_equal(np.asarray(a.c1), limbs_to_numpy(b.c1))
    got = t["eng"].dcd(t["eng"].dec(b, t["sk"]))
    assert np.array_equal(got, j["eng"].dcd(j["eng"].dec(a, j["sk"])))
    if name not in decoded:
        return
    want = _expected(name, t["A"], t["m"])
    if name in ("sum", "sum_hoisted", "nrm2"):
        got = got[:1] * np.ones(SLOTS)      # the sum lands in slot 0
    assert np.max(np.abs(got - want)) < tol


def check_routes(runs):
    """The full route serves the whole bank, returns None for the restricted
    one, and no call fell back to the classic path."""
    j, t = runs[:2]
    for r in (j, t):
        assert r["full"] is not None and r["full_none"] is None
        assert r["fallbacks"] == 0
    assert j["dims"] == t["dims"]
    assert torch.equal(t["full"].c0, t["via_gemv"].c0)


@pytest.mark.parametrize("name", ALL)
def test_linalg_bit_equal(runs, name):
    check_bit_equal(runs, name)


def test_routes_taken(runs):
    check_routes(runs)


def test_zrotdiag_equal():
    A, _ = _inputs()
    for idx in range(SLOTS):
        for rot in (0, -2, 1):
            assert np.array_equal(jlin.zrotdiag(A, idx, rot, SLOTS),
                                  tlin.zrotdiag(A, idx, rot, SLOTS))


def test_gemv_hoisted_needs_a_hoisted_plan():
    eng = gt.CKKS(gt.HeContext(**RINGS["logp59"][0]), rng=gt.Surf(), device="cpu")
    A, _ = _inputs()
    with pytest.raises(ValueError, match="HoistedGemvPlan"):
        tlin.gemv(eng, None, None, {}, plan=tlin.GemvPlan(eng, A), hoisted=True)


def test_fallback_warns_and_counts():
    """On the 59-bit chain at logn=11/logq=48 the hoisting basis exceeds the
    switch keys' primes: gemv_hoisted warns once, counts one fallback, and
    gives the classic path's ciphertext, in both packages."""
    ring_kw = dict(logn=11, q=1 << 48, slots=4, Delta=1 << 22)
    outs = []
    for pkg, lin, surf, kw in ((gpqhe_tpu, jlin, jsurf, {}),
                               (gt, tlin, tsurf, {"device": "cpu"})):
        eng = pkg.CKKS(pkg.HeContext(**ring_kw), rng=surf.Surf(), **kw)
        pk, sk = eng.keypair()
        rk = eng.genrk(sk)
        A, m = _inputs()
        ct = eng.enc_pk(eng.ecd(m), pk)
        plan = lin.HoistedGemvPlan(eng, A)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = lin.gemv_hoisted(eng, plan, ct, rk)
        msgs = [str(w.message) for w in caught if "falling back" in str(w.message)]
        assert len(msgs) == 1 and f"dimswk_h={eng.dimswk_h}" in msgs[0]
        assert plan.fallbacks == 1
        classic = lin.gemv(eng, None, ct, rk, plan=plan)
        outs.append((out, classic))
    (jo, jc), (to, tc) = outs
    assert np.array_equal(np.asarray(jo.c0), limbs_to_numpy(to.c0))
    assert np.array_equal(np.asarray(jo.c1), limbs_to_numpy(to.c1))
    assert torch.equal(to.c0, tc.c0) and torch.equal(to.c1, tc.c1)
    assert np.array_equal(np.asarray(jo.c0), np.asarray(jc.c0))
