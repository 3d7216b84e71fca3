"""The port's key-switch path against the JAX package's, bit for bit.

At logn=11/logq=48/slots=4/Delta=2^22, on the default 59-bit chain and on
logp=29, both engines draw keys and encryption noise from the same Surf()
stream and messages from one numpy seed (the JAX engine on its butterfly NTT
backend with its programs jitted as they are, the port on its plain CPU
twin).  galois, rot with every key of the bank, conj, mulpt, mul_rs_batch
(B = 1, 2) and the hoisted gemv's prologue and step programs must give
bit-equal limbs (tolerance 0) and equal decodes, within the Delta=2^22
noise budget (1e-3) of the plaintext result.  Conjugation and rotation keys made by the JAX engine load into
the port through from_numpy (alone and as a bank) and give the same
ciphertexts.  The golden KAT's conj and rot1 entries replay on the port.
"""

import json
import os

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.substrate import surf as jsurf
from gpqhe_tpu.utils import serialize

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch import params
from gpqhe_tpu_torch.ops.modmath import torch_to_u64
from gpqhe_tpu_torch.ring import sample as tsmp
from gpqhe_tpu_torch.scheme.types import from_numpy, limbs_to_numpy, to_numpy
from gpqhe_tpu_torch.substrate import surf as tsurf

torch.set_num_threads(1)

PARAMS = dict(logn=11, q=1 << 48, slots=4, Delta=1 << 22)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_logn11.json")
ROTS = [0, 1, 2, 3]


def _messages():
    rng = np.random.default_rng(20)
    return [rng.random(4) + 1j * rng.random(4) for _ in range(3)]


def _run(pkg, surf, logp, **kw):
    """The shared op sequence; returns every object it made, by name."""
    ctx = pkg.HeContext(**PARAMS, logp=logp)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    m1, m2, m3 = _messages()
    ct1 = eng.enc_pk(eng.ecd(m1), pk)
    ct2 = eng.enc_pk(eng.ecd(m2), pk)
    out = dict(eng=eng, sk=sk, rlk=rlk, ck=ck, rk=rk, m1=m1, m2=m2, ct1=ct1, ct2=ct2)
    qb = eng.qbits(ct1.l)
    out["galois"] = {r: eng.ring.galois(ct1.c0, r, qb) for r in ROTS + [None]}
    out["rot"] = {r: eng.rot(ct1.copy(), r, rk) for r in ROTS}
    out["conj"] = eng.conj(ct1.copy(), ck)
    low = eng.rs(eng.mul(ct1, ct2, rlk))                     # one level down
    out["rot_low"] = eng.rot(low, 1, rk)
    pt = eng.ecd(m3)
    out["mulpt"] = eng.mulpt(ct1, pt)
    out["mulpt_rs"] = eng.rs(out["mulpt"])
    out["mulpt_const"] = eng.mulpt(ct2, eng.const_pt(0.5 - 0.25j))
    out["mul_rs"] = [eng.mul_rs(ct1, ct2, rlk), eng.mul_rs(ct2, ct2, rlk)]
    out["batch1"] = eng.mul_rs_batch([ct1], [ct2], rlk)
    out["batch2"] = eng.mul_rs_batch([ct1, ct2], [ct2, ct2], rlk)
    out["norm"] = (eng.canemb_norm(m1), eng.canemb_norm_pt(pt))
    return out


@pytest.fixture(scope="module", params=[59, 29], ids=["logp59", "logp29"])
def runs(request):
    logp = request.param
    return _run(gpqhe_tpu, jsurf, logp), _run(gt, tsurf, logp, device="cpu")


def _ct_equal(a, b):
    assert (a.l, a.nu, a.B) == (b.l, b.nu, b.B)
    assert np.array_equal(np.asarray(a.c0), limbs_to_numpy(b.c0))
    assert np.array_equal(np.asarray(a.c1), limbs_to_numpy(b.c1))


def _dcd(run, ct):
    return run["eng"].dcd(run["eng"].dec(ct, run["sk"]))


@pytest.mark.parametrize("name", ["ck"] + [f"rk{r}" for r in ROTS])
def test_switch_keys_bit_equal(runs, name):
    j, t = runs
    a, b = (j["ck"], t["ck"]) if name == "ck" else (j["rk"][int(name[2:])], t["rk"][int(name[2:])])
    assert b.p0hat.shape[0] == t["eng"].dimswk_h == j["eng"].dimswk_h
    assert np.array_equal(np.asarray(a.p0hat), torch_to_u64(b.p0hat))
    assert np.array_equal(np.asarray(a.p1hat), torch_to_u64(b.p1hat))


@pytest.mark.parametrize("rot", ROTS + [None])
def test_galois_bit_equal(runs, rot):
    j, t = runs
    assert np.array_equal(np.asarray(j["galois"][rot]), limbs_to_numpy(t["galois"][rot]))
    src, neg = j["eng"].ring.galois_map(rot)
    tsrc, tneg = t["eng"].ring.galois_map(rot)
    assert np.array_equal(src, tsrc.numpy()) and np.array_equal(neg, tneg.numpy())


@pytest.mark.parametrize("rot", ROTS)
def test_rot_bit_equal(runs, rot):
    j, t = runs
    _ct_equal(j["rot"][rot], t["rot"][rot])
    got = _dcd(t, t["rot"][rot])
    assert np.array_equal(got, _dcd(j, j["rot"][rot]))
    assert np.max(np.abs(got - np.roll(t["m1"], -rot))) < 1e-3   # Delta=2^22 budget


@pytest.mark.parametrize("name", ["conj", "rot_low", "mulpt", "mulpt_rs", "mulpt_const"])
def test_ciphertexts_bit_equal(runs, name):
    j, t = runs
    _ct_equal(j[name], t[name])


def test_conj_and_mulpt_decode(runs):
    j, t = runs
    got = _dcd(t, t["conj"])
    assert np.array_equal(got, _dcd(j, j["conj"]))
    assert np.max(np.abs(got - np.conj(t["m1"]))) < 1e-3         # Delta=2^22 budget
    m3 = _messages()[2]
    assert np.max(np.abs(_dcd(t, t["mulpt_rs"]) - t["m1"] * m3)) < 1e-3


@pytest.mark.parametrize("name,i", [("batch1", 0), ("batch2", 0), ("batch2", 1)])
def test_mul_rs_batch_bit_equal(runs, name, i):
    """Each batch element equals the JAX batch program's and the port's own
    single mul_rs of that pair."""
    j, t = runs
    _ct_equal(j[name][i], t[name][i])
    one = t["mul_rs"][i]
    assert torch.equal(t[name][i].c0, one.c0) and torch.equal(t[name][i].c1, one.c1)
    assert (t[name][i].l, t[name][i].nu, t[name][i].B) == (one.l, one.nu, one.B)


def test_canemb_norms_equal(runs):
    j, t = runs
    assert j["norm"] == t["norm"]


def test_jax_keys_load_through_from_numpy(runs, tmp_path):
    """A conjugation key and a rotation-key bank the JAX engine made, saved
    in its serialize layout, give the JAX engine's conj and rot in the port."""
    j, t = runs
    eng = t["eng"]
    ck_path, rk_path = str(tmp_path / "ck.npz"), str(tmp_path / "rk.npz")
    serialize.save(ck_path, j["eng"].ctx, j["ck"])
    serialize.save(rk_path, j["eng"].ctx, j["rk"])
    z = np.load(ck_path)
    ck = from_numpy(str(z["kind"]), dict(z), eng.device)
    z = np.load(rk_path)
    assert str(z["kind"]) == "rk"
    rk = from_numpy("rk", dict(z), eng.device)
    assert sorted(rk) == ROTS
    _ct_equal(j["conj"], eng.conj(t["ct1"].copy(), ck))
    for r in ROTS:
        _ct_equal(j["rot"][r], eng.rot(t["ct1"].copy(), r, rk))


def test_rotation_bank_roundtrip(runs):
    _, t = runs
    kind, arrays = to_numpy(t["rk"])
    assert kind == "rk" and list(arrays["rots"]) == ROTS
    back = from_numpy(kind, arrays, t["eng"].device)
    for r in ROTS:
        assert torch.equal(back[r].p0hat, t["rk"][r].p0hat)
        assert torch.equal(back[r].p1hat, t["rk"][r].p1hat)


def test_hoisted_programs_bit_equal():
    """hoisted_gemv_prep_fn / step_fn on the logp=29 chain (the 59-bit chain
    at logq=48 has no primes to spare for the hoisting basis:
    test_torch_linalg.py runs it on a ring that has)."""
    import jax.numpy as jnp
    outs = []
    for pkg, surf, kw in ((gpqhe_tpu, jsurf, {}), (gt, tsurf, {"device": "cpu"})):
        ctx = pkg.HeContext(**PARAMS, logp=29)
        eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
        pk, sk = eng.keypair()
        rk = eng.genrk(sk, rotations=[0, 1])
        ct = eng.enc_pk(eng.ecd(_messages()[0]), pk)
        pts = [eng.ecd(m) for m in _messages()[1:]]
        l, n1 = ct.l, 2
        bnd = max(p.size_bound for p in pts) * n1
        dims_h, dimc = eng.gemv_dims(l, bnd)
        assert dims_h <= eng.dimswk_h
        stack = jnp.stack if pkg is gpqhe_tpu else torch.stack
        prep = eng.hoisted_gemv_prep_fn(l, n1, dims_h, dimc)
        step = eng.hoisted_gemv_step_fn(l, dims_h, dimc,
                                        bits_h=eng.bits_hoist(l, bnd),
                                        bits_c=ctx.bits_mulpt(l, bnd))
        c1p, c0p = prep(ct.c0, ct.c1)
        ptx = stack([eng.ring.fwd_ntt(p.m, dims_h, signed_bits=p.mod_bits) for p in pts])
        ptb = stack([eng.ring.fwd_ntt(p.m, dimc, signed_bits=p.mod_bits) for p in pts])
        o0, o1 = step(c1p, c0p, ptx, ptb, stack([rk[r].p0hat for r in (0, 1)]),
                      stack([rk[r].p1hat for r in (0, 1)]))
        outs.append((dims_h, dimc, c1p, c0p, o0, o1))
    (jh, jc, *ja), (th, tc, *ta) = outs
    assert (jh, jc) == (th, tc)
    assert np.array_equal(np.asarray(ja[0]), torch_to_u64(ta[0]))
    assert np.array_equal(np.asarray(ja[1]), torch_to_u64(ta[1]))
    assert np.array_equal(np.asarray(ja[2]), limbs_to_numpy(ta[2]))
    assert np.array_equal(np.asarray(ja[3]), limbs_to_numpy(ta[3]))


def test_golden_conj_rot_replay():
    """tests/test_golden.py's conj and rot1 entries on the port."""
    with open(GOLDEN) as f:
        g = {k: np.array([complex(a, b) for a, b in v]) for k, v in json.load(f).items()}
    ctx = gt.HeContext(logn=11, q=1 << 48, slots=4, Delta=1 << 20)
    eng = gt.CKKS(ctx, rng=gt.Surf(), device="cpu")
    pk, sk = eng.keypair()
    eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    m0 = tsmp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m0), pk)
    assert np.array_equal(m0, g["m0"])
    tol_ks = (params.BLKSIZ + 2) / ctx.Delta
    for name, ct in (("conj", eng.conj(ct1.copy(), ck)), ("rot1", eng.rot(ct1.copy(), 1, rk))):
        diff = float(np.max(np.abs(eng.dcd(eng.dec(ct, sk)) - g[name])))
        assert diff < tol_ks, f"{name}: diff {diff} vs reference binary (tol {tol_ks})"


def test_default_device_is_the_gpu():
    """CKKS(ctx) with no device means CUDA: it raises where there is none."""
    ctx = gt.HeContext(**PARAMS)
    if torch.cuda.is_available():
        assert gt.CKKS(ctx, rng=gt.Surf()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            gt.CKKS(ctx, rng=gt.Surf())
        with pytest.raises(RuntimeError, match="CUDA"):
            gt.ring.poly.RingEngine(ctx.poly)


@pytest.mark.parametrize("hoist_bits", [None, 0, 120])
def test_hoist_bits_sets_the_switch_key_width(hoist_bits):
    """The switch keys' prime count follows hoist_bits as in the JAX engine."""
    widths = []
    for pkg, kw in ((gpqhe_tpu, {}), (gt, {"device": "cpu"})):
        ctx = pkg.HeContext(**PARAMS, logp=29)
        widths.append(pkg.CKKS(ctx, hoist_bits=hoist_bits, **kw).dimswk_h)
    assert widths[0] == widths[1]
    if hoist_bits == 0:
        assert widths[1] == ctx.dimswk
