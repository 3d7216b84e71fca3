"""The port's algo/nonlinear.py against the JAX package's, bit for bit.

At logn=6/logq=400/slots=4/Delta=2^30 (L=13, q_0=2^10: he_cmp at iter=1,
alpha=2 takes 12 levels and ends at l=1), both engines draw keys and
encryption noise from the same Surf() stream and messages from one numpy
seed; the JAX engine runs its butterfly backend with its programs jitted as
they are, the port its plain CPU twin.  he_inv, he_sqrt, he_sigmoid, he_log, he_exp, he_cmp and he_cmppt
must give bit-equal ciphertexts (c0, c1, l; nu and B equal as floats;
tolerance 0) and equal decodes, within the stated tolerance of a plaintext
model of the same iteration.  This file holds the checks and runs them on
the default 59-bit chain; test_torch_nonlinear29.py runs them on logp=29
(building the JAX programs is slow, so the chains run as separate files).
The reference binary's nonlinear and cmp KATs at logn=14 / logn=15 replay
on the port under `slow`.
"""

import json
import os

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.algo import nonlinear as jnl
from gpqhe_tpu.substrate import surf as jsurf

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.algo import nonlinear as tnl
from gpqhe_tpu_torch.ring import sample as tsmp
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
from gpqhe_tpu_torch.substrate import surf as tsurf

torch.set_num_threads(1)

PARAMS = dict(logn=6, q=1 << 400, slots=4, Delta=1 << 30)
OPS = ["inv", "sqrt", "sigmoid", "log", "exp", "cmp", "cmppt"]
GDIR = os.path.join(os.path.dirname(__file__), "golden")


def _messages():
    rng = np.random.default_rng(44)
    m = rng.random(4) * 0.6 + 0.3 + 1j * (rng.random(4) * 0.6 + 0.3)
    return m, m.real + 0j, m.imag + 0j


def _run(pkg, nl, surf, logp, **kw):
    ctx = pkg.HeContext(**PARAMS, logp=logp)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m, ma, mb = _messages()

    def enc(x):
        return eng.enc_pk(eng.ecd(np.asarray(x, dtype=np.complex128)), pk)
    out = dict(eng=eng, sk=sk)
    out["inv"] = nl.he_inv(eng, enc(ma + 0.5), rlk, 2)
    out["sqrt"] = nl.he_sqrt(eng, enc(ma), rlk, 2)
    out["sigmoid"] = nl.he_sigmoid(eng, enc(m / 10), rlk)
    out["log"] = nl.he_log(eng, enc(ma / 10), rlk)
    out["exp"] = nl.he_exp(eng, 1.0, enc(m), rlk, 2)
    out["cmp"] = nl.he_cmp(eng, enc(ma), enc(mb), rlk, 1, 2)
    out["cmppt"] = nl.he_cmppt(eng, enc(ma), eng.ecd(mb), rlk, 1, 2)
    return out


def both_runs(logp):
    return (_run(gpqhe_tpu, jnl, jsurf, logp),
            _run(gt, tnl, tsurf, logp, device="cpu"))


def _model(name):
    """(plaintext result of the same iteration, tolerance).  inv and sqrt
    follow the evaluator's own recurrence (ref: src/he-algo.c:131-206), so
    only encryption and rescale noise at Delta=2^30 separates them: 1e-4,
    the per-op CLI's gate.  exp is Taylor to x^7 on m/4, squared twice:
    1e-4.  sigmoid (degree 9) and log (degree 10) are the evaluator's
    polynomials against the true function: the CLI's 1e-3 and 1e-2."""
    m, ma, _ = _messages()
    if name == "inv":
        x = ma + 0.5
        an, bn = 2 - x, 1 - x
        for _ in range(2):
            bn = bn * bn
            an = an * (bn + 1)
        return an, 1e-4
    if name == "sqrt":
        an, bn = ma, ma - 1
        for _ in range(2):
            an = an * (1 - bn / 2)
            bn = bn * bn * (bn - 3) / 4
        return an, 1e-4
    if name == "sigmoid":
        return 1 / (1 + np.exp(-m / 10)), 1e-3
    if name == "log":
        return np.log(1 + ma / 10), 1e-2
    if name == "exp":
        return np.exp(m), 1e-4
    return None, None


def check_bit_equal(runs, name):
    j, t = runs
    a, b = j[name], t[name]
    assert (a.l, a.nu, a.B) == (b.l, b.nu, b.B)
    assert np.array_equal(np.asarray(a.c0), limbs_to_numpy(b.c0))
    assert np.array_equal(np.asarray(a.c1), limbs_to_numpy(b.c1))
    got = t["eng"].dcd(t["eng"].dec(b, t["sk"]))
    assert np.array_equal(got, j["eng"].dcd(j["eng"].dec(a, j["sk"])))
    want, tol = _model(name)
    if want is not None:
        assert np.max(np.abs(got - want)) < tol
    else:                       # a soft comparison: every slot in [0, 1]
        assert np.all(np.abs(got - 0.5) < 0.6)


@pytest.fixture(scope="module")
def runs():
    return both_runs(59)


@pytest.mark.parametrize("name", OPS)
def test_nonlinear_bit_equal_59bit_chain(runs, name):
    check_bit_equal(runs, name)


def test_algo_package_exports_match():
    import gpqhe_tpu.algo as ja
    import gpqhe_tpu_torch.algo as ta
    for name in ("he_cmp", "he_cmppt", "he_exp", "he_inv", "he_log", "he_sigmoid",
                 "he_sqrt"):
        assert hasattr(ja, name) and hasattr(ta, name)


def _golden(name):
    with open(os.path.join(GDIR, name)) as f:
        return {k: np.array([complex(a, b) for a, b in v])
                for k, v in json.load(f).items()}


@pytest.mark.slow
def test_golden_algo_nonlinear_on_the_port():
    """tests/test_golden_algo.py's nonlinear KAT (the reference binary's inv,
    exp, sigmoid, log, sqrt at logn=14/logq=438/slots=4/Delta=2^30) replayed
    on the port, within the same 1e-4 gate."""
    g = _golden("golden_algo_nonlinear.json")
    ctx = gt.HeContext(logn=14, q=1 << 438, slots=4, Delta=1 << 30)
    eng = gt.CKKS(ctx, rng=gt.Surf(), device="cpu")
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m0 = tsmp.sample_z01vec(eng.rng, ctx.slots)
    assert np.array_equal(m0, g["m0"])
    a = 2j * np.pi / float(1 << 30)
    cts = {name: eng.enc_pk(eng.ecd(np.asarray(msg, dtype=np.complex128)), pk)
           for name, msg in [("inv", m0.real + 0.5), ("exp", m0 * a), ("sigmoid", m0 / 10),
                             ("log", m0.real / 100000), ("sqrt", m0.real + 0j)]}

    def dec(out):
        return eng.dcd(eng.dec(out, sk))
    assert np.max(np.abs(dec(tnl.he_inv(eng, cts["inv"], rlk, 5)) - g["inv"])) < 1e-4
    assert np.max(np.abs(dec(tnl.he_exp(eng, a, cts["exp"], rlk, 5)) - g["exp"])) < 1e-4
    assert np.max(np.abs(dec(tnl.he_sigmoid(eng, cts["sigmoid"], rlk)) - g["sigmoid"])) < 1e-4
    assert np.max(np.abs(dec(tnl.he_log(eng, cts["log"], rlk)) - g["log"])) < 1e-4
    assert np.max(np.abs(dec(tnl.he_sqrt(eng, cts["sqrt"], rlk, 6)) - g["sqrt"])) < 1e-4


@pytest.mark.slow
def test_golden_algo_cmp_on_the_port():
    """The reference binary's cmp KAT at logn=15/logq=881/slots=4/Delta=2^30,
    iter=5, alpha=2, replayed on the port within the same 1e-4 gate."""
    g = _golden("golden_algo_cmp.json")
    ctx = gt.HeContext(logn=15, q=1 << 881, slots=4, Delta=1 << 30)
    eng = gt.CKKS(ctx, rng=gt.Surf(), device="cpu")
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m0 = tsmp.sample_z01vec(eng.rng, ctx.slots)
    m0 = tsmp.sample_z01vec(eng.rng, ctx.slots)   # sampled twice (ref :1041)
    assert np.array_equal(m0, g["m0"])
    ma, mb = m0.real + 0.5, m0.imag + 0.5
    ct1 = eng.enc_pk(eng.ecd(np.asarray(ma, dtype=np.complex128)), pk)
    ct2 = eng.enc_pk(eng.ecd(np.asarray(mb, dtype=np.complex128)), pk)
    got = eng.dcd(eng.dec(tnl.he_cmp(eng, ct1, ct2, rlk, iter=5, alpha=2), sk))
    assert np.max(np.abs(got - g["cmp"])) < 1e-4
    assert np.array_equal(np.round(got.real), (ma > mb).astype(float))
