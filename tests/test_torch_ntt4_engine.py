"""The port's "matmul" NTT backend (ops/ntt4.py) in the engine, against the
JAX package's matmul backend and the port's own butterfly engine.

Three engines draw from their own Surf() stream, the same byte stream, at
logn=8/q=2^120/slots=4/Delta=2^30 and run the same op sequence: the JAX
CKKS(ctx, ntt_impl="matmul"), the port's CKKS(ctx, device="cpu",
ntt_impl="matmul") and the port's butterfly engine.  The matmul engines'
NTT-resident key words (rlk, ck, rk: the four-step order) and every
ciphertext are bit-equal; the butterfly engine holds its keys in another
order, but every ciphertext it makes is the same (the pointwise products do
not depend on the order).  Also: the hoisted gemv's fallback under matmul
as JAX takes it, the hoisting assertion, the mesh's refusal, a bad backend
name, and the CLI's --impl.
"""

import warnings

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.algo import linalg as jlinalg
from gpqhe_tpu.ring import sample as jsmp
from gpqhe_tpu.substrate import surf as jsurf

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch import cli as tcli
from gpqhe_tpu_torch.algo import linalg as tlinalg
from gpqhe_tpu_torch.ops.modmath import torch_to_u64
from gpqhe_tpu_torch.parallel.engine import MeshCKKS
from gpqhe_tpu_torch.parallel.mesh import make_he_mesh3
from gpqhe_tpu_torch.ring import sample as tsmp
from gpqhe_tpu_torch.ring.poly import RingEngine
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
from gpqhe_tpu_torch.substrate import surf as tsurf

torch.set_num_threads(1)

PARAMS = dict(logn=8, q=1 << 120, slots=4, Delta=1 << 30)


def _run(pkg, surf, smp, linalg, **kw):
    """The shared op sequence; every object it made, by name."""
    ctx = pkg.HeContext(**PARAMS)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rlk, ck, rk = eng.genrlk(sk), eng.genck(sk), eng.genrk(sk)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    m2 = smp.sample_z01vec(eng.rng, ctx.slots)
    A = smp.sample_z01vec(eng.rng, ctx.slots * ctx.slots)
    ct1, ct2 = eng.enc_pk(eng.ecd(m1), pk), eng.enc_pk(eng.ecd(m2), pk)
    out = dict(eng=eng, sk=sk, pk=pk, rlk=rlk, ck=ck, rk=rk, ct1=ct1, ct2=ct2, m1=m1, A=A)
    out["mul_rs"] = eng.mul_rs(ct1, ct2, rlk)
    out["rot"] = eng.rot(ct1, 1, rk)
    out["conj"] = eng.conj(ct1, ck)
    out["mulpt"] = eng.mulpt(ct1, eng.ecd(m2))
    out["rs"] = eng.rs(out["mulpt"])
    out["moddown"] = eng.moddown(ct1)
    plan = linalg.HoistedGemvPlan(eng, A)
    out["full"] = linalg.gemv_hoisted_full(eng, plan, ct1, rk)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["gemv"] = linalg.gemv_hoisted(eng, plan, ct1, rk)
    out["fallbacks"] = plan.fallbacks
    out["classic"] = linalg.gemv(eng, None, ct1, rk, plan=plan)
    out["warnings"] = [str(w.message) for w in caught if "falling back" in str(w.message)]
    return out


@pytest.fixture(scope="module")
def runs():
    return {"jax": _run(gpqhe_tpu, jsurf, jsmp, jlinalg, ntt_impl="matmul"),
            "matmul": _run(gt, tsurf, tsmp, tlinalg, device="cpu", ntt_impl="matmul"),
            "butterfly": _run(gt, tsurf, tsmp, tlinalg, device="cpu")}


KEYS = ["rlk", "ck", "rk0", "rk1", "rk3"]
CTS = ["ct1", "ct2", "mul_rs", "rot", "conj", "mulpt", "rs", "moddown", "classic"]


def _key(run, name):
    return run["rk"][int(name[2:])] if name.startswith("rk") else run[name]


@pytest.mark.parametrize("name", KEYS)
def test_ntt_resident_keys_bit_equal_to_jax(runs, name):
    j, t, b = (_key(runs[e], name) for e in ("jax", "matmul", "butterfly"))
    for f in ("p0hat", "p1hat"):
        a, w = np.asarray(getattr(j, f)), torch_to_u64(getattr(t, f))
        assert a.shape == w.shape and np.array_equal(a, w), f
    # the same key in the butterfly order is another word array
    assert not np.array_equal(torch_to_u64(b.p0hat), torch_to_u64(t.p0hat))


def test_public_key_and_secret_key_equal(runs):
    j, t, b = runs["jax"], runs["matmul"], runs["butterfly"]
    for f in ("p0", "p1"):
        assert np.array_equal(np.asarray(getattr(j["pk"], f)), limbs_to_numpy(getattr(t["pk"], f)))
        assert torch.equal(getattr(t["pk"], f), getattr(b["pk"], f))
    assert torch.equal(t["sk"].s, b["sk"].s)


@pytest.mark.parametrize("name", CTS)
def test_ciphertexts_bit_equal_to_jax_and_butterfly(runs, name):
    j, t, b = runs["jax"][name], runs["matmul"][name], runs["butterfly"][name]
    assert (j.l, j.nu, j.B) == (t.l, t.nu, t.B) == (b.l, b.nu, b.B)
    for f in ("c0", "c1"):
        assert np.array_equal(np.asarray(getattr(j, f)), limbs_to_numpy(getattr(t, f))), f
        assert torch.equal(getattr(t, f), getattr(b, f)), f


def test_hoisted_gemv_is_the_classic_one(runs):
    """Under matmul gemv_hoisted falls back to the classic gemv: JAX's and
    the port's equal, and equal to the classic gemv of either backend (the
    butterfly engine's own gemv_hoisted takes another route)."""
    j, t, b = runs["jax"]["gemv"], runs["matmul"]["gemv"], runs["butterfly"]["classic"]
    for f in ("c0", "c1"):
        assert np.array_equal(np.asarray(getattr(j, f)), limbs_to_numpy(getattr(t, f))), f
        assert torch.equal(getattr(t, f), getattr(b, f)), f
        assert torch.equal(getattr(t, f), getattr(runs["matmul"]["classic"], f)), f


def test_decodes(runs):
    t = runs["matmul"]
    eng, sk, m1 = t["eng"], t["sk"], t["m1"]
    got = eng.dcd(eng.dec(t["gemv"], sk))
    want = t["A"].reshape(eng.ctx.slots, eng.ctx.slots) @ m1
    assert np.max(np.abs(got - want)) < 1e-5
    assert np.max(np.abs(eng.dcd(eng.dec(t["rot"], sk)) - np.roll(m1, -1))) < 1e-5


def test_hoisted_gemv_falls_back_as_jax(runs):
    j, t, b = runs["jax"], runs["matmul"], runs["butterfly"]
    assert j["full"] is None and t["full"] is None and b["full"] is not None
    assert j["fallbacks"] == t["fallbacks"] == 1 and b["fallbacks"] == 0
    assert len(t["warnings"]) == 1 and t["warnings"] == j["warnings"]
    assert "ntt_impl='matmul'" in t["warnings"][0] and not b["warnings"]


def test_hoisting_asserts_the_butterfly_order(runs):
    for e in ("jax", "matmul"):
        eng = runs[e]["eng"]
        with pytest.raises(AssertionError, match="butterfly NTT-domain ordering"):
            eng.hoisted_gemv_prep_fn(eng.ctx.L, 2, eng.ctx.dim, eng.ctx.dim)(None, None)


def test_bad_backend_and_mesh_refused():
    ctx = gt.HeContext(**PARAMS)
    with pytest.raises(ValueError, match="ntt_impl='bogus'"):
        RingEngine(ctx.poly, device="cpu", ntt_impl="bogus")
    with pytest.raises(ValueError, match="ntt_impl='bogus'"):
        gt.CKKS(ctx, device="cpu", ntt_impl="bogus")
    mesh = make_he_mesh3(4, limb=2, coeff=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="butterfly NTT"):
        MeshCKKS(ctx, mesh, ntt_impl="matmul")
    assert MeshCKKS(ctx, mesh, ntt_impl="pallas").ring.ntt_impl == "pallas"


SMALL = ["--logn=5", "--logq=100", "--slots=2", "--logDelta=30", "--device=cpu"]


def test_cli_impl(capsys):
    assert tcli.main(["mul", "pk", "--impl=matmul"] + SMALL) == 0
    out = capsys.readouterr().out
    assert any(ln.startswith("[ok] mul: diff = ") for ln in out.splitlines())
    assert tcli.main(["mul", "pk", "--impl=matmul", "--mesh=2x2x1:virtual"] + SMALL) == 2
    out = capsys.readouterr().out
    assert "--impl=matmul does not run on a mesh" in out and "[ok]" not in out
    assert tcli.main(["mul", "--impl=fft"] + SMALL) == 1
    assert "--impl=fft" in capsys.readouterr().out
    assert tcli.main([]) == 1
    assert "--impl=butterfly|matmul|pallas" in capsys.readouterr().out
