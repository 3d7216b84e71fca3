"""The port's CKKS engine against the JAX package's, end to end.

Both engines draw from their own Surf() stream, which is the same byte
stream, so at logn=11/logq=48/slots=4/Delta=2^22 the keys, ciphertexts and
the mul_rs and rs(mul) outputs must be bit-equal (the JAX engine on its
butterfly NTT backend, the port on its plain CPU twin).  Keys and
ciphertexts written by the JAX package in its serialize layout load into the
port through from_numpy and give the same mul_rs.  The golden KAT replays at
Delta=2^20 within tests/test_golden.py's tolerances.  A slow test runs the
main path's size, logn=14/logq=438 (tests/test_torch_cuda.py holds the
CUDA engine bit-equal to the CPU one on a GPU).
"""

import json
import os

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.ring import sample as jsmp
from gpqhe_tpu.substrate import surf as jsurf
from gpqhe_tpu.utils import serialize

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch import params
from gpqhe_tpu_torch.ops.modmath import torch_to_u64
from gpqhe_tpu_torch.ring import sample as tsmp
from gpqhe_tpu_torch.substrate import surf as tsurf
from gpqhe_tpu_torch.scheme.types import from_numpy, limbs_to_numpy, to_numpy

torch.set_num_threads(1)

PARAMS = dict(logn=11, q=1 << 48, slots=4, Delta=1 << 22)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_logn11.json")


def _run(pkg, surf, smp, device=None):
    """The shared op sequence; returns every object it made, by name."""
    ctx = pkg.HeContext(**PARAMS)
    kw = {} if device is None else {"device": device}
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    m2 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m1), pk)
    ct2 = eng.enc_pk(eng.ecd(m2), pk)
    out = dict(eng=eng, pk=pk, sk=sk, rlk=rlk, m1=m1, m2=m2, ct1=ct1, ct2=ct2)
    out["mul_rs"] = eng.mul_rs(ct1, ct2, rlk)
    out["rs_mul"] = eng.rs(eng.mul(ct1, ct2, rlk))
    out["dec"] = eng.dec(out["mul_rs"], sk)
    out["add"] = eng.add(ct1, ct2)
    out["sub"] = eng.sub(ct1, ct2)
    out["neg"] = eng.neg(ct1)
    out["addpt"] = eng.addpt(ct1, eng.const_pt(0.25 - 0.5j))
    out["moddown"] = eng.moddown(ct1)
    out["enc_sk"] = eng.enc_sk(eng.ecd(m1), sk)
    return out


@pytest.fixture(scope="module")
def runs():
    return _run(gpqhe_tpu, jsurf, jsmp), _run(gt, tsurf, tsmp, device="cpu")


KEYS = {"pk.p0": ("pk", "p0"), "pk.p1": ("pk", "p1"), "sk.s": ("sk", "s"),
        "rlk.p0hat": ("rlk", "p0hat"), "rlk.p1hat": ("rlk", "p1hat")}
CTS = ["ct1", "ct2", "mul_rs", "rs_mul", "add", "sub", "neg", "addpt", "moddown", "enc_sk"]


@pytest.mark.parametrize("name", list(KEYS))
def test_keys_bit_equal(runs, name):
    j, t = runs
    obj, field = KEYS[name]
    a, b = np.asarray(getattr(j[obj], field)), getattr(t[obj], field)
    b = torch_to_u64(b) if a.dtype == np.uint64 else limbs_to_numpy(b)
    assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", CTS)
def test_ciphertexts_bit_equal(runs, name):
    j, t = runs
    a, b = j[name], t[name]
    assert (a.l, a.nu, a.B) == (b.l, b.nu, b.B)
    assert np.array_equal(np.asarray(a.c0), limbs_to_numpy(b.c0))
    assert np.array_equal(np.asarray(a.c1), limbs_to_numpy(b.c1))


def test_decrypt_decode_equal(runs):
    j, t = runs
    assert np.array_equal(np.asarray(j["dec"].m), limbs_to_numpy(t["dec"].m))
    got = t["eng"].dcd(t["dec"])
    assert np.array_equal(j["eng"].dcd(j["dec"]), got)
    assert np.max(np.abs(got - t["m1"] * t["m2"])) < 1e-3   # Delta=2^22 budget


def test_jax_objects_load_through_from_numpy(runs, tmp_path):
    """Keys and ciphertexts the JAX engine made, saved in its serialize
    layout, run in the port and give the JAX engine's mul_rs."""
    j, t = runs
    eng = t["eng"]
    loaded = {}
    for name in ("rlk", "ct1", "ct2", "sk"):
        path = str(tmp_path / f"{name}.npz")
        serialize.save(path, j["eng"].ctx, j[name])
        z = np.load(path)
        loaded[name] = from_numpy(str(z["kind"]), dict(z), eng.device)
    out = eng.mul_rs(loaded["ct1"], loaded["ct2"], loaded["rlk"])
    want = j["mul_rs"]
    assert np.array_equal(np.asarray(want.c0), limbs_to_numpy(out.c0))
    assert np.array_equal(np.asarray(want.c1), limbs_to_numpy(out.c1))
    assert (out.l, out.nu, out.B) == (want.l, want.nu, want.B)
    dec = eng.dcd(eng.dec(out, loaded["sk"]))
    assert np.array_equal(dec, j["eng"].dcd(j["dec"]))


@pytest.mark.parametrize("name", ["pk", "sk", "rlk", "ct1", "dec"])
def test_to_numpy_roundtrip(runs, name):
    _, t = runs
    obj = t[name]
    kind, arrays = to_numpy(obj)
    back = from_numpy(kind, arrays, t["eng"].device)
    assert type(back) is type(obj)
    for f, v in vars(obj).items():
        w = getattr(back, f)
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w), f
        else:
            assert v == w, f


def test_golden_replay():
    """tests/test_golden.py's sequence (without conj/rot) on the port."""
    with open(GOLDEN) as f:
        g = {k: np.array([complex(a, b) for a, b in v]) for k, v in json.load(f).items()}
    ctx = gt.HeContext(logn=11, q=1 << 48, slots=4, Delta=1 << 20)
    eng = gt.CKKS(ctx, rng=gt.Surf(), device="cpu")
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    eng.genck(sk)
    eng.genrk(sk)
    m0 = tsmp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m0), pk)
    m1 = tsmp.sample_z01vec(eng.rng, ctx.slots)
    ct2 = eng.enc_pk(eng.ecd(m1), pk)
    assert np.array_equal(m0, g["m0"]) and np.array_equal(m1, g["m1"])

    def dcd(ct):
        return eng.dcd(eng.dec(ct, sk))
    tol_ks = (params.BLKSIZ + 2) / ctx.Delta
    checks = {
        "enc": (dcd(ct1), 1e-9),
        "add": (dcd(eng.add(ct1, ct2)), 1e-9),
        "mulrs": (dcd(eng.rs(eng.mul(ct1, ct2, rlk))), tol_ks),
        "moddown": (dcd(eng.moddown(ct1)), 1e-9),
    }
    for name, (got, tol) in checks.items():
        diff = float(np.max(np.abs(got - g[name])))
        assert diff < tol, f"{name}: diff {diff} vs reference binary (tol {tol})"


# -- tests/test_scheme.py's ring (logn=12/q=2^109/slots=4/Delta=2^30) --------------

SCHEME12 = dict(logn=12, q=1 << 109, slots=4, Delta=1 << 30)


def _scheme12(pkg, surf, smp, **kw):
    """Keys for every slot rotation, an encryption of a message from the
    stream, its rotation by every r, and test_ecd_product_norm's plaintext
    product through RingEngine.poly_mul."""
    ctx = pkg.HeContext(**SCHEME12)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rk = eng.genrk(sk)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct0 = eng.enc_pk(eng.ecd(m0), pk)
    s = ctx.slots
    m1 = np.array([(1 - i / s) + 1j * (1 - i / s) for i in range(s)])
    m2 = np.array([(0.99 - i / s) + 1j * (0.99 - i / s) for i in range(s)])
    pt1, pt2 = eng.ecd(m1), eng.ecd(m2)
    dim = (2 * ctx.q[ctx.L].bit_length()) // ctx.logp_prime + 1
    prod = eng.ring.poly_mul(pt1.m, pt2.m, dim, 32 * eng.kq, eng.kq,
                             signed_a=pt1.mod_bits, signed_b=pt2.mod_bits)
    pt = type(pt1)(nu=pt1.nu * pt2.nu, m=prod, mod_bits=32 * eng.kq)
    return dict(eng=eng, sk=sk, m0=m0, m1=m1, m2=m2, prod=pt,
                rot=[eng.rot(ct0.copy(), r, rk) for r in range(s)])


@pytest.fixture(scope="module")
def scheme12():
    return (_scheme12(gpqhe_tpu, jsurf, jsmp), _scheme12(gt, tsurf, tsmp, device="cpu"))


@pytest.mark.parametrize("r", range(SCHEME12["slots"]))
def test_rot_all(scheme12, r):
    """test_scheme.py::test_rot_all: rotation by r within 1e-5 of the rolled
    message, bit-equal to the JAX package's."""
    j, t = scheme12
    a, b = j["rot"][r], t["rot"][r]
    assert (a.l, a.nu, a.B) == (b.l, b.nu, b.B)
    assert np.array_equal(np.asarray(a.c0), limbs_to_numpy(b.c0))
    assert np.array_equal(np.asarray(a.c1), limbs_to_numpy(b.c1))
    got = t["eng"].dcd(t["eng"].dec(b, t["sk"]))
    assert np.max(np.abs(got - np.roll(t["m0"], -r))) < 1e-5


def test_ecd_product_norm(scheme12):
    """test_scheme.py::test_ecd_product_norm: a plaintext product through
    RingEngine.poly_mul decodes within 1e-5 of m1 * m2; its limbs equal the
    JAX package's."""
    j, t = scheme12
    assert np.array_equal(np.asarray(j["prod"].m), limbs_to_numpy(t["prod"].m))
    got = t["eng"].dcd(t["prod"])
    assert np.max(np.abs(got - t["m1"] * t["m2"])) < 1e-5


def test_kemctx_sizes():
    """test_parity.py::test_kemctx_sizes at its ring (logn=10/q=2^27)."""
    eng = gt.CKKS(gt.HeContext(logn=10, q=1 << 27, slots=4, Delta=1 << 21), rng=gt.Surf(),
                  device="cpu")
    k = eng.ctx.kemctx()
    n = eng.ctx.poly.n
    assert k["polybytes"] == (eng.ctx.poly.logq + 1) * n // 8
    assert k["pkbytes"] == k["polybytes"] + 32
    assert k["ssbytes"] == 4 * (n // 2) * 16
    assert k == gpqhe_tpu.HeContext(logn=10, q=1 << 27, slots=4, Delta=1 << 21).kemctx()


def test_full_width_checks_at_a_small_ring():
    """torch_cases.py's full_width_checks (tests/test_torch_cuda.py runs them
    at logn=14/logq=438/slots=16/Delta=2^50 on the card) at logn=9/q=2^120/
    slots=16/Delta=2^30 on the CPU: every decode within 1e-5, a rotation by
    each of the 16 slots."""
    from torch_cases import full_width_checks
    eng = gt.CKKS(gt.HeContext(logn=9, q=1 << 120, slots=16, Delta=1 << 30), rng=gt.Surf(),
                  device="cpu")
    pk, sk = eng.keypair()
    out = full_width_checks(eng, pk, sk, eng.genrlk(sk), eng.genck(sk), eng.genrk(sk))
    assert out["mul_level_ok"]
    assert [f"rot{r}" for r in range(16)] == [k for k in out["diffs"] if k.startswith("rot")]
    assert max(out["diffs"].values()) < 1e-5, out["diffs"]


@pytest.mark.slow
def test_main_path_size_decodes():
    """logn=14/logq=438/slots=16/Delta=2^50: decode diff < 1e-5 (bench.py's gate)."""
    ctx = gt.HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50)
    eng = gt.CKKS(ctx, rng=gt.Surf(), device="cpu")
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m1 = tsmp.sample_z01vec(eng.rng, ctx.slots)
    m2 = tsmp.sample_z01vec(eng.rng, ctx.slots)
    ct = eng.mul_rs(eng.enc_pk(eng.ecd(m1), pk), eng.enc_pk(eng.ecd(m2), pk), rlk)
    got = eng.dcd(eng.dec(ct, sk))
    assert np.max(np.abs(got - m1 * m2)) < 1e-5
