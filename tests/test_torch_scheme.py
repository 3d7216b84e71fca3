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
