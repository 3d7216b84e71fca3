"""The port's bootstrap stages against the JAX package's, bit for bit.

Stage ring: logn=5/logq=220/slots=2/Delta=2^30 (L=7, q_0=2^10, gap=8: three
SubSum rotations).  Both engines draw keys and encryption noise from the
same Surf() stream and the message from one numpy seed; the JAX engine runs
its butterfly backend with its programs jitted as they are, the port its
plain CPU twin.  subsum, coeff2slot and slot2coeff at the ordinary scale
and under raised_delta (the per-op CLI's composition), rlsin and _exp_small_a (iter=1) must give
bit-equal ciphertexts (tolerance 0), equal ledgers and equal plan.fallbacks;
the plaintexts behind EvalSin's two awkward constants (2 pi Delta / (q_src
2^iter) at scale Delta^2, q_src / (4 pi i Delta) at Delta) must have equal
limbs, bounds and mulpt basis sizes.  raise_modulus is held on edge words at
the reference-scale ladder (logq=881: kq=28 limbs, q_1=2^41, q_0=2^11), and
rescale at every one of its 29 levels against Python integers.  This file
holds the checks and runs them on the default 59-bit chain;
test_torch_bootstrap29.py runs the stages on logp=29, and
test_torch_bootstrap_e2e.py the whole pipeline.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu import bootstrap as jbs
from gpqhe_tpu.substrate import surf as jsurf

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch import bootstrap as tbs
from gpqhe_tpu_torch.ring.canemb import invcanemb
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy, limbs_to_torch
from gpqhe_tpu_torch.substrate import bigint
from gpqhe_tpu_torch.substrate import surf as tsurf

torch.set_num_threads(1)

STAGE = dict(logn=5, q=1 << 220, slots=2, Delta=1 << 30)
REF = dict(logn=5, q=1 << 881, slots=4, Delta=1 << 30)
CTS = ["subsum", "c2s_real", "c2s_imag", "s2c", "c2s_raised_real", "c2s_raised_imag",
       "s2c_raised", "rlsin", "exp_small"]
PLANS = ["U0_conjT", "U0_T", "U1_conjT", "U1_T", "U0", "U1"]


def _message():
    rng = np.random.default_rng(7)
    return 0.1 * (rng.random(2) + 1j * rng.random(2))


def _run(pkg, bs, surf, logp, **kw):
    ctx = pkg.HeContext(**STAGE, logp=logp)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m = _message()
    ct = eng.enc_pk(eng.ecd(m), pk)
    out = dict(eng=eng, sk=sk, m=m, ct=ct, rlk=rlk, ck=ck, rk=rk, rots=sorted(rk))
    out["subsum"] = bs.subsum(eng, ct, rk)
    bctx = out["bctx"] = bs.BootstrapContext(eng)
    out["c2s_real"], out["c2s_imag"] = bs.coeff2slot(eng, bctx, ct, ck, rk)
    out["s2c"] = bs.slot2coeff(eng, bctx, out["c2s_real"], out["c2s_imag"], rk)
    # the per-op CLI's coeff2slot composition: encode scale and nu ledger
    # raised to q_L for the duration (at this small modulus the product
    # wraps, so only bits and ledgers are compared, not the decode)
    out["delta"] = [eng.Delta]
    raised = bs.BootstrapContext(eng)       # its diagonals are encoded at the raised scale
    with bs.raised_delta(eng, float(ctx.q[ct.l])):
        out["delta"].append(eng.Delta)
        ct_r = ct.copy()
        ct_r.nu = eng.Delta
        out["c2s_raised_real"], out["c2s_raised_imag"] = bs.coeff2slot(eng, raised, ct_r, ck, rk)
        out["s2c_raised"] = bs.slot2coeff(eng, raised, out["c2s_raised_real"],
                                          out["c2s_raised_imag"], rk)
        out["const_raised"] = eng.const_pt(0.25 - 0.5j)
    out["delta"].append(eng.Delta)
    out["fallbacks"] = {name: (bctx.plan(name).fallbacks, raised.plan(name).fallbacks)
                        for name in PLANS}
    out["rlsin"] = bs.rlsin(eng, 2 * np.pi, ct, rlk, ck, 1)
    q_src = float(ctx.q[1])
    a = 2 * np.pi * eng.Delta / q_src
    out["exp_small"] = bs._exp_small_a(eng, a * 1j, ct, rlk, 1)
    # EvalSin's two constants as bootstrap() encodes them
    out["pt_small"] = eng.ecd(np.full(ctx.slots, a * 1j / 2, dtype=np.complex128),
                              nu=eng.Delta ** 2)
    out["pt_huge"] = eng.ecd(np.full(ctx.slots, q_src / (4j * np.pi * eng.Delta),
                                     dtype=np.complex128))
    out["dims"] = {name: [ctx.dim_mulpt(l, out[name].size_bound) for l in range(1, ctx.L + 1)]
                   for name in ("pt_small", "pt_huge")}
    return out


def both_runs(logp):
    return (_run(gpqhe_tpu, jbs, jsurf, logp),
            _run(gt, tbs, tsurf, logp, device="cpu"))


def ct_equal(a, b):
    assert (a.l, a.nu, a.B) == (b.l, b.nu, b.B)
    assert np.array_equal(np.asarray(a.c0), limbs_to_numpy(b.c0))
    assert np.array_equal(np.asarray(a.c1), limbs_to_numpy(b.c1))


def check_stage(runs, name):
    j, t = runs
    ct_equal(j[name], t[name])
    got = t["eng"].dcd(t["eng"].dec(t[name], t["sk"]))
    assert np.array_equal(got, j["eng"].dcd(j["eng"].dec(j[name], j["sk"])))
    m = t["m"]
    if name == "rlsin":         # (e^{iam} - conj(e^{iam})) / 2ia; the per-op CLI's gate
        a = 2 * np.pi
        assert np.max(np.abs(got - np.exp(-a * m.imag) * np.sin(a * m.real) / a)) < 1e-3
    elif name == "s2c":         # slot2coeff undoes coeff2slot
        assert np.max(np.abs(got - m)) < 1e-5
    elif name in ("c2s_real", "c2s_imag"):      # the slots hold the encode coefficients
        ctx = t["eng"].ctx
        u = invcanemb(m, ctx.slots, ctx.poly.cyc_group, ctx.poly.ring_zetas, ctx.poly.m)
        part = u.real if name == "c2s_real" else u.imag
        assert np.max(np.abs(got - np.round(part * ctx.Delta) / ctx.Delta)) < 1e-5
    elif name == "exp_small":   # exp(i a m) with a = 2 pi Delta / q_1 ~ 3e-3
        a = 2 * np.pi * t["eng"].Delta / float(t["eng"].ctx.q[1])
        assert np.max(np.abs(got - np.exp(1j * a * m))) < 1e-4


def check_plaintexts(runs):
    j, t = runs
    assert j["rots"] == t["rots"] == [0, 1, 2, 4, 8]
    assert j["delta"] == t["delta"] and t["delta"][1] == float(1 << 220)
    assert j["fallbacks"] == t["fallbacks"]
    assert j["dims"] == t["dims"]
    for name in ("pt_small", "pt_huge", "const_raised"):
        a, b = j[name], t[name]
        assert (a.nu, a.mod_bits, a.bound) == (b.nu, b.mod_bits, b.bound), name
        assert np.array_equal(np.asarray(a.m), limbs_to_numpy(b.m)), name


def check_iter_too_small(runs):
    msgs = []
    for r, bs in zip(runs, (jbs, tbs)):
        with pytest.raises(ValueError, match="EvalSin range condition") as e:
            bs.bootstrap(r["eng"], r["bctx"], r["ct"], r["rlk"], r["ck"], r["rk"], iter=1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert jbs.min_bootstrap_iter(runs[0]["eng"].ctx) == \
        tbs.min_bootstrap_iter(runs[1]["eng"].ctx) == 7     # h = n/2 = 16


@pytest.fixture(scope="module")
def runs():
    return both_runs(59)


@pytest.mark.parametrize("name", CTS)
def test_stage_bit_equal_59bit_chain(runs, name):
    check_stage(runs, name)


def test_plaintexts_and_plans_59bit_chain(runs):
    check_plaintexts(runs)


def test_iter_too_small_raises_59bit_chain(runs):
    check_iter_too_small(runs)


# -- raise_modulus and rescale at the reference-scale ladder ------------------

@pytest.fixture(scope="module")
def ref_engines():
    return (gpqhe_tpu.CKKS(gpqhe_tpu.HeContext(**REF), rng=jsurf.Surf()),
            gt.CKKS(gt.HeContext(**REF), rng=tsurf.Surf(), device="cpu"))


def _edge_words(ctx, l, klv, seed):
    """n coefficients below 2^nbits(q_l): the sign boundary of the centring
    (q_l/2 - 1, q_l/2, q_l/2 + 1), both ends, q_l itself, and random words."""
    n, ql = ctx.poly.n, ctx.q[l]
    rng = np.random.default_rng(seed)
    vals = [0, 1, ql // 2 - 1, ql // 2, ql // 2 + 1, ql - 1, ql, 2 * ql - 1]
    vals += [int.from_bytes(rng.bytes(8 * klv), "little") % (2 * ql)
             for _ in range(n - len(vals))]
    return vals, bigint.ints_to_limbs(vals, klv)


@pytest.mark.parametrize("l", [0, 1, 2, 15, 28])
def test_raise_modulus_edge_words(ref_engines, l):
    je, te = ref_engines
    ctx = te.ctx
    assert (ctx.L, te.kq, ctx.q[1].bit_length() - 1, ctx.q[0].bit_length() - 1) == (29, 28, 41, 11)
    klv = te.kl(l)
    v0, c0 = _edge_words(ctx, l, klv, 2 * l)
    v1, c1 = _edge_words(ctx, l, klv, 2 * l + 1)
    jct = gpqhe_tpu.Ciphertext(l=l, nu=2.0 ** 30, B=3.5, c0=jnp.asarray(c0), c1=jnp.asarray(c1))
    tct = gt.Ciphertext(l=l, nu=2.0 ** 30, B=3.5, c0=limbs_to_torch(c0), c1=limbs_to_torch(c1))
    for nu in (None, 2.0 ** 30):
        a, b = jbs.raise_modulus(je, jct, nu=nu), tbs.raise_modulus(te, tct, nu=nu)
        assert a.l == b.l == 29 and b.c0.shape == (ctx.poly.n, 28)
        ct_equal(a, b)
    # and against Python integers: centre mod q_l, then reduce mod 2^nbits(q_L)
    ql, top = ctx.q[l], 1 << ctx.q[29].bit_length()
    want = [((v % ql) - ql if (v % ql) >= ql // 2 else v % ql) % top for v in v0]
    assert bigint.limbs_to_ints(limbs_to_numpy(b.c0)) == want


@pytest.mark.parametrize("l", list(range(29, 0, -1)))
def test_rescale_every_level_against_integers(ref_engines, l):
    """rs at kq=28 limbs down to the one-limb levels: round(c / 2^30) with
    remainder ties rounding down, mod 2^nbits(q_{l-1})."""
    _, te = ref_engines
    ctx = te.ctx
    vals, c = _edge_words(ctx, l, te.kl(l), 100 + l)
    vals[2:5] = [1 << 29, (1 << 29) + 1, (3 << 29)]          # the rounding boundary
    c = bigint.ints_to_limbs(vals, te.kl(l))
    ct = gt.Ciphertext(l=l, nu=2.0 ** 60, B=1.0, c0=limbs_to_torch(c), c1=limbs_to_torch(c))
    out = te.rs(ct)
    mod = 1 << ctx.q[l - 1].bit_length()
    want = [((v >> 30) + (1 if (v & ((1 << 30) - 1)) > (1 << 29) else 0)) % mod for v in vals]
    assert out.l == l - 1 and out.c0.shape[-1] == te.kl(l - 1)
    assert bigint.limbs_to_ints(limbs_to_numpy(out.c0)) == want
    assert torch.equal(out.c0, out.c1)


@pytest.mark.parametrize("l", [29, 2, 1])
def test_rescale_and_moddown_match_jax_at_the_ladders_ends(ref_engines, l):
    je, te = ref_engines
    _, c = _edge_words(te.ctx, l, te.kl(l), 200 + l)
    jct = gpqhe_tpu.Ciphertext(l=l, nu=2.0 ** 60, B=1.0, c0=jnp.asarray(c), c1=jnp.asarray(c))
    tct = gt.Ciphertext(l=l, nu=2.0 ** 60, B=1.0, c0=limbs_to_torch(c), c1=limbs_to_torch(c))
    ct_equal(je.rs(jct), te.rs(tct))
    ct_equal(je.moddown(jct), te.moddown(tct))


def test_rotation_sets_match():
    for kw in (STAGE, REF, dict(logn=15, q=1 << 881, slots=4, Delta=1 << 30)):
        j, t = gpqhe_tpu.HeContext(**kw), gt.HeContext(**kw)
        assert jbs.subsum_rotations(j) == tbs.subsum_rotations(t)
        assert jbs.bootstrap_rotations(j) == tbs.bootstrap_rotations(t)
        assert jbs.min_bootstrap_iter(j) == tbs.min_bootstrap_iter(t)
    assert len(tbs.bootstrap_rotations(t)) == 16 and tbs.min_bootstrap_iter(t) == 9
    assert math.ceil(math.log2(4 * math.pi * 33)) == 9
