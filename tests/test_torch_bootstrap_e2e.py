"""The port's whole bootstrap against the JAX package's, bit for bit.

The JAX package's own smoke parameters (tests/test_bootstrap_smoke.py):
logn=4, slots=2, q=2^610, Delta=2^30, iter=6 (L=20, q_0=2^10, h=8), the
cheapest composition that runs every stage (raise -> SubSum -> coeff2slot ->
EvalSin -> slot2coeff).  Both engines draw keys and noise from the same
Surf() stream; the JAX engine builds one program per (op, level), which is
why this file runs the JAX reference once, on the default 59-bit chain, and
keeps to itself.  The bootstrapped ciphertext must be bit-equal (tolerance
0) with equal ledgers and equal plan.fallbacks, and decode within 1e-2 of
the message (the reference's bootstrap gate).  A second bootstrap from a
higher level reuses the JAX engine's programs: it must warn about the
q_src/(4 pi Delta) amplification in both packages and still agree bit for
bit.  The logp=29 chain's whole bootstrap is under `slow`.
"""

import warnings

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu import bootstrap as jbs
from gpqhe_tpu.ring import sample as jsmp
from gpqhe_tpu.substrate import surf as jsurf

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch import bootstrap as tbs
from gpqhe_tpu_torch.ring import sample as tsmp
from gpqhe_tpu_torch.substrate import surf as tsurf

from test_torch_bootstrap import PLANS, ct_equal

torch.set_num_threads(1)

SMOKE = dict(logn=4, q=1 << 610, slots=2, Delta=1 << 30)


def _run(pkg, bs, smp, surf, logp, **kw):
    ctx = pkg.HeContext(**SMOKE, logp=logp)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m0 = smp.sample_z01vec(eng.rng, ctx.slots) * 0.1
    ct = eng.enc_pk(eng.ecd(m0), pk)
    while ct.l > 2:
        ct = eng.moddown(ct)
    ct2, ct = ct, eng.moddown(ct)
    bctx = bs.BootstrapContext(eng)
    out = dict(eng=eng, sk=sk, m0=m0, ct=ct)
    out["boot"] = bs.bootstrap(eng, bctx, ct, rlk, ck, rk, iter=6)
    out["fallbacks"] = {name: bctx.plan(name).fallbacks for name in PLANS}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out["boot_l2"] = bs.bootstrap(eng, bctx, ct2, rlk, ck, rk, iter=6)
    out["warned"] = [str(x.message) for x in w if "is large" in str(x.message)]
    return out


@pytest.fixture(scope="module")
def runs():
    return (_run(gpqhe_tpu, jbs, jsmp, jsurf, 59),
            _run(gt, tbs, tsmp, tsurf, 59, device="cpu"))


def test_bootstrap_bit_equal(runs):
    j, t = runs
    assert np.array_equal(j["m0"], t["m0"])
    ct_equal(j["ct"], t["ct"])
    ct_equal(j["boot"], t["boot"])
    assert j["fallbacks"] == t["fallbacks"]


def test_bootstrap_regains_levels_and_decodes(runs):
    _, t = runs
    eng = t["eng"]
    assert t["ct"].l == 1 and t["boot"].l > t["ct"].l + 3
    got = eng.dcd(eng.dec(t["boot"], t["sk"]))
    assert np.max(np.abs(got - t["m0"])) < 1e-2


def test_bootstrap_from_a_large_modulus_warns_alike(runs):
    j, t = runs
    assert len(t["warned"]) == 1 and j["warned"] == t["warned"]
    ct_equal(j["boot_l2"], t["boot_l2"])


@pytest.mark.slow
def test_bootstrap_bit_equal_logp29_chain():
    j = _run(gpqhe_tpu, jbs, jsmp, jsurf, 29)
    t = _run(gt, tbs, tsmp, tsurf, 29, device="cpu")
    ct_equal(j["boot"], t["boot"])
    assert j["fallbacks"] == t["fallbacks"]
    got = t["eng"].dcd(t["eng"].dec(t["boot"], t["sk"]))
    assert np.max(np.abs(got - t["m0"])) < 1e-2


@pytest.mark.slow
def test_bootstrap_reference_scale_on_the_port():
    """tests/test_bootstrap_refscale.py on the port's CPU twin: logn=15,
    logq=881, slots=4, Delta=2^30, iter derived (9)."""
    ctx = gt.HeContext(logn=15, q=1 << 881, slots=4, Delta=1 << 30)
    eng = gt.CKKS(ctx, rng=gt.Surf(), device="cpu")
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, tbs.bootstrap_rotations(ctx))
    m0 = tsmp.sample_z01vec(eng.rng, ctx.slots) * 0.1
    ct = eng.enc_pk(eng.ecd(m0), pk)
    while ct.l > 1:
        ct = eng.moddown(ct)
    boot = tbs.bootstrap(eng, tbs.BootstrapContext(eng), ct, rlk, ck, rk)
    assert boot.l >= 10
    assert np.max(np.abs(eng.dcd(eng.dec(boot, sk)) - m0)) < 1e-2
