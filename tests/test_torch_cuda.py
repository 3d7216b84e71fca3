"""The port on an NVIDIA GPU: the two CUDA NTT kernels (u64 words for the
59-bit chain, u32 words for a logp=29 chain) against the plain torch twin,
and the CUDA engine against the CPU engine, bit for bit, on both chains.

Every test here needs the card and skips without one.  The file imports
neither jax nor gpqhe_tpu, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(--noconftest: tests/conftest.py configures jax for the JAX package's tests.)
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (bootstrap_cases, c2s_packing_case, crt_chain_case,  # the repository
                        crt_chain_ring, equal_cts, gemv_packing_case,       # root is on
                        oracle_module)                                      # sys.path
from gpqhe_tpu_torch import CKKS, HeContext, Surf         # (python -m pytest)
from gpqhe_tpu_torch import bootstrap as bs
from gpqhe_tpu_torch.algo import linalg, nonlinear
from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import ntt as twin
from gpqhe_tpu_torch.ops import ntt_cuda, ntt_cuda32
from gpqhe_tpu_torch.ops.modmath import u64_to_torch
from gpqhe_tpu_torch.ring import sample
from gpqhe_tpu_torch.ring.poly import RingEngine

torch.set_num_threads(1)

MODES = ["fwd", "inv", "inv_scaled"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU build)")
    return torch.device("cuda")


def _twin(a, ba, mode):
    if mode == "fwd":
        return twin.ntt(a, ba.zetas, ba.ps, ba.pinv)
    scale = ba.ninvphat_mont if mode == "inv_scaled" else ba.ninv_mont
    return twin.intt(a, ba.zetas_inv, ba.ps, ba.pinv, scale)


LOGNS = [4, 7, 8, 9, 11, 14, 15, 16]
# (primes, batch): 1 slab, 3 slabs, 132 slabs
SLABS = [(1, ()), (3, ()), (3, (44,))]
_rings = {}


def _ring(logn, logp, device):
    if (logn, logp) not in _rings:
        _rings[logn, logp] = RingEngine(PolyContext(logn, q=1 << 20, logp=logp, dim_cap=3),
                                        device=device)
    return _rings[logn, logp]


def _check_kernel(device, logn, dim, batch, mode, logp):
    """One transform through the ring: one more launch of this chain's
    kernel and none of the other's, torch.equal to the twin."""
    ring = _ring(logn, logp, device)
    mine, other = ((ntt_cuda.LAUNCHES, ntt_cuda32.LAUNCHES32) if logp == 59
                   else (ntt_cuda32.LAUNCHES32, ntt_cuda.LAUNCHES))
    assert ring.ntt_mod is (ntt_cuda if logp == 59 else ntt_cuda32)
    rng = np.random.default_rng(logn)
    ps = np.array(ring.pctx.primes[:dim], dtype=np.uint64)[:, None]
    host = rng.integers(0, 1 << 62, batch + (dim, 1 << logn), dtype=np.uint64) % ps
    host[..., :2] = ps - np.uint64(1)                  # p - 1: the largest input
    a = u64_to_torch(host, device)
    before, before_other = dict(mine), dict(other)
    got = (ring.ntt_f(a, dim) if mode == "fwd"
           else ring.ntt_i(a, dim, scale_phatinv=mode == "inv_scaled"))
    torch.cuda.synchronize()
    assert mine[mode] == before[mode] + 1 and other == before_other
    assert torch.equal(got, _twin(a, ring.ba(dim), mode))


@pytest.mark.cuda
@pytest.mark.parametrize("dim,batch", SLABS)
@pytest.mark.parametrize("logn", LOGNS)
@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernel_matches_twin(cuda_device, logn, dim, batch, mode):
    _check_kernel(cuda_device, logn, dim, batch, mode, 59)


@pytest.mark.cuda
def test_cuda_kernel_takes_an_unaligned_view(cuda_device):
    """A contiguous view 8 bytes off a 16-byte boundary: the wrapper copies it
    (the row pass loads 16 bytes a thread)."""
    ring = _ring(9, 59, cuda_device)
    ps = np.array(ring.pctx.primes[:3], dtype=np.uint64)[:, None]
    host = np.random.default_rng(1).integers(0, 1 << 62, (3, 512), dtype=np.uint64) % ps
    flat = torch.zeros(3 * 512 + 1, dtype=torch.int64, device=cuda_device)
    flat[1:] = u64_to_torch(host, cuda_device).reshape(-1)
    a = flat[1:].view(3, 512)
    assert a.is_contiguous() and a.data_ptr() % 16 == 8
    for mode in MODES:
        got = (ring.ntt_f(a, 3) if mode == "fwd"
               else ring.ntt_i(a, 3, scale_phatinv=mode == "inv_scaled"))
        assert torch.equal(got, _twin(a, ring.ba(3), mode))


@pytest.mark.cuda
def test_cuda_kernel_rejects_unsupported_n(cuda_device):
    ring = RingEngine(PolyContext(4, q=1 << 20, dim_cap=2), device=cuda_device)
    plan = ring.ntt_plan(2)
    with pytest.raises(ValueError, match="does not match"):
        ntt_cuda.ntt(torch.zeros((2, 32), dtype=torch.int64, device=cuda_device), plan)
    with pytest.raises(ValueError, match="int64"):
        ntt_cuda.ntt(torch.zeros((2, 16), dtype=torch.int32, device=cuda_device), plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,batch", SLABS)
@pytest.mark.parametrize("logn", LOGNS)
@pytest.mark.parametrize("mode", MODES)
def test_cuda_u32_kernel_matches_twin(cuda_device, logn, dim, batch, mode):
    _check_kernel(cuda_device, logn, dim, batch, mode, 29)


@pytest.mark.cuda
def test_cuda_kernels_reject_the_other_chains_plan(cuda_device):
    wide = RingEngine(PolyContext(4, q=1 << 20, dim_cap=2), device=cuda_device)
    narrow = RingEngine(PolyContext(4, q=1 << 20, logp=29, dim_cap=2), device=cuda_device)
    a = torch.zeros((2, 16), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="u64 tables"):
        ntt_cuda32.ntt(a, wide.ntt_plan(2))
    with pytest.raises(ValueError, match="u32 tables"):
        ntt_cuda.ntt(a, narrow.ntt_plan(2))


def _run(device):
    ctx = HeContext(logn=11, q=1 << 48, slots=4, Delta=1 << 22)
    eng = CKKS(ctx, rng=Surf(), device=device)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m1 = sample.sample_z01vec(eng.rng, ctx.slots)
    m2 = sample.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m1), pk)
    ct2 = eng.enc_pk(eng.ecd(m2), pk)
    out = eng.mul_rs(ct1, ct2, rlk)
    return dict(rlk=rlk, ct1=ct1, mul_rs=out, rs_mul=eng.rs(eng.mul(ct1, ct2, rlk)),
                dcd=eng.dcd(eng.dec(out, sk)))


@pytest.mark.cuda
def test_cuda_engine_matches_cpu(cuda_device):
    before = dict(ntt_cuda.LAUNCHES)
    c = _run(cuda_device)
    t = _run(torch.device("cpu"))
    assert all(ntt_cuda.LAUNCHES[k] > before[k] for k in MODES)
    for name in ("ct1", "mul_rs", "rs_mul"):
        assert c[name].c0.is_cuda
        assert torch.equal(c[name].c0.cpu(), t[name].c0), name
        assert torch.equal(c[name].c1.cpu(), t[name].c1), name
    assert torch.equal(c["rlk"].p0hat.cpu(), t["rlk"].p0hat)
    assert torch.equal(c["rlk"].p1hat.cpu(), t["rlk"].p1hat)
    assert np.array_equal(c["dcd"], t["dcd"])


def _run_keyswitch(device, logp):
    """rot, conj, mulpt, mul_rs_batch and both hoisted gemv routes on a ring
    with room for the hoisting basis on either chain."""
    ctx = HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30, logp=logp)
    eng = CKKS(ctx, rng=Surf(), device=device)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    rng = np.random.default_rng(9)
    m = rng.random(4) + 1j * rng.random(4)
    A = rng.random(16) + 1j * rng.random(16)
    ct = eng.enc_pk(eng.ecd(m), pk)
    plan = linalg.HoistedGemvPlan(eng, A)
    bank = {r: rk[r] for r in rk if r < plan.n1 or r % plan.n1 == 0}
    out = dict(rot=eng.rot(ct, 1, rk), conj=eng.conj(ct, ck),
               mulpt=eng.mulpt(ct, eng.ecd(m)),
               batch=eng.mul_rs_batch([ct, ct], [ct, ct], rlk)[1],
               full=linalg.gemv_hoisted_full(eng, plan, ct, rk),
               bsgs=linalg.gemv_hoisted(eng, plan, ct, bank))
    assert plan.fallbacks == 0
    return out, eng.dcd(eng.dec(out["full"], sk)), A.reshape(4, 4) @ m


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_keyswitch_path_matches_cpu(cuda_device, logp):
    mine, other = ((ntt_cuda.LAUNCHES, ntt_cuda32.LAUNCHES32) if logp == 59
                   else (ntt_cuda32.LAUNCHES32, ntt_cuda.LAUNCHES))
    before, before_other = dict(mine), dict(other)
    c, got, want = _run_keyswitch(cuda_device, logp)
    assert all(mine[k] > before[k] for k in MODES) and other == before_other
    t, got_cpu, _ = _run_keyswitch(torch.device("cpu"), logp)
    for name in c:
        assert c[name].c0.is_cuda
        assert torch.equal(c[name].c0.cpu(), t[name].c0), name
        assert torch.equal(c[name].c1.cpu(), t[name].c1), name
    assert np.array_equal(got, got_cpu)
    assert np.max(np.abs(got - want)) < 1e-5


@pytest.mark.cuda
def test_default_device_is_cuda(cuda_device):
    eng = CKKS(HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30), rng=Surf())
    assert eng.device.type == "cuda" and eng.ring.device.type == "cuda"


# -- the deep-circuit path: the bootstrap ring's shapes, and its ops ----------

BOOT_CASES = ["mul fwd", "swk fwd", "key fwd", "mul inv_scaled", "swk inv_scaled", "dec inv"]
_boot = {}


def _boot_engine(device):
    if "eng" not in _boot:
        _boot["eng"] = CKKS(HeContext(15, 1 << 881, 4, 1 << 30), rng=Surf(), device=device)
    return _boot["eng"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BOOT_CASES)
def test_cuda_kernel_at_the_bootstrap_rings_shapes(cuda_device, case):
    """logn=15/logq=881: the shapes he_mul, the key switch, keygen and
    decryption launch at the top level, read from the engine."""
    eng = _boot_engine(cuda_device)
    assert (eng.ctx.L, eng.kq, eng.ctx.dim, eng.ctx.dimswk, eng.dimswk_h) == (29, 28, 16, 47, 48)
    mode, shape = bootstrap_cases(eng)["ntt15"][BOOT_CASES.index(case)]
    assert case.split()[1] == mode and shape[-1] == 1 << 15
    dim = shape[-2]
    ring = eng.ring
    ps = np.array(ring.pctx.primes[:dim], dtype=np.uint64)[:, None]
    host = np.random.default_rng(dim).integers(0, 1 << 62, shape, dtype=np.uint64) % ps
    host[..., :2] = ps - np.uint64(1)
    a = u64_to_torch(host, cuda_device)
    before = dict(ntt_cuda.LAUNCHES)
    got = (ring.ntt_f(a, dim) if mode == "fwd"
           else ring.ntt_i(a, dim, scale_phatinv=mode == "inv_scaled"))
    torch.cuda.synchronize()
    assert ntt_cuda.LAUNCHES[mode] == before[mode] + 1
    assert torch.equal(got, _twin(a, ring.ba(dim), mode))


def _run_deep(device, logp):
    """he_inv, SubSum and a modulus raise from l=1 on a ring with a deep
    ladder (logn=9/logq=250/slots=4/Delta=2^30: L=8, q_0=2^10)."""
    ctx = HeContext(logn=9, q=1 << 250, slots=4, Delta=1 << 30, logp=logp)
    eng = CKKS(ctx, rng=Surf(), device=device)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    rk = eng.genrk(sk, bs.subsum_rotations(ctx))
    m = np.random.default_rng(15).random(4) * 0.5 + 0.5
    ct = eng.enc_pk(eng.ecd(m + 0j), pk)
    low = ct
    while low.l > 1:
        low = eng.moddown(low)
    out = dict(inv=nonlinear.he_inv(eng, ct, rlk, 3), subsum=bs.subsum(eng, ct, rk),
               raised=bs.raise_modulus(eng, low, nu=eng.Delta))
    return out, eng.dcd(eng.dec(out["inv"], sk)), 1 / m


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_deep_circuit_ops_match_cpu(cuda_device, logp):
    c, got, want = _run_deep(cuda_device, logp)
    t, got_cpu, _ = _run_deep(torch.device("cpu"), logp)
    for name in c:
        assert c[name].c0.is_cuda and c[name].l == t[name].l
        assert torch.equal(c[name].c0.cpu(), t[name].c0), name
        assert torch.equal(c[name].c1.cpu(), t[name].c1), name
    assert c["raised"].l == 8 and c["raised"].c0.shape[-1] == 8
    assert np.array_equal(got, got_cpu)
    assert np.max(np.abs(got - want)) < 1e-3       # Goldschmidt, 3 iterations, x in [0.5, 1]


# -- the mesh engine: per-shard plans on the kernels, virtual meshes of the card --

from gpqhe_tpu_torch.parallel import mesh as pmesh           # noqa: E402
from gpqhe_tpu_torch.parallel.engine import MeshCKKS         # noqa: E402


def _virtual(device, limb, coeff, batch=1):
    n = limb * coeff * batch
    return pmesh.make_he_mesh3(n, limb=limb, coeff=coeff, devices=[device] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("logn,S", [(8, 2), (8, 4), (8, 16), (11, 8), (14, 2)])
def test_cuda_kernel_on_shard_plans_matches_twin(cuda_device, logn, S, logp):
    """The local stages of the coefficient-sharded NTT: both kernels at
    length n/S (down to the kernel's minimum, 16) on the tables of every
    coefficient shard, for limb shard 1's rows, forward and inverse with the
    ring's n^-1: one launch each, torch.equal to the twin on the same tables."""
    pctx = _ring(logn, logp, cuda_device).pctx
    mod, mine = ((ntt_cuda, ntt_cuda.LAUNCHES) if logp == 59
                 else (ntt_cuda32, ntt_cuda32.LAUNCHES32))
    mesh = _virtual(cuda_device, 3, S)
    splan, C = pmesh._basis_consts(mesh, pctx, 3, 2, "a")
    assert splan["ntt"] is mod and splan["L"] == (1 << logn) // S
    rng = np.random.default_rng(logn * S)
    for s in range(S):
        plan = C[1, s, 0]["a_ntt"]
        assert (plan.dim, plan.n, plan.scale_phat) == (1, (1 << logn) // S, None)
        assert plan.tables.tw_f.is_contiguous() and plan.tables.word == (64 if logp == 59 else 32)
        p = np.uint64(pctx.primes[1])
        host = rng.integers(0, 1 << 62, (2, 1, plan.n), dtype=np.uint64) % p
        host[..., :2] = p - np.uint64(1)
        a = u64_to_torch(host, cuda_device)
        before = dict(mine)
        hat = mod.ntt(a, plan)
        back = mod.intt(hat, plan)
        torch.cuda.synchronize()
        assert (mine["fwd"], mine["inv"]) == (before["fwd"] + 1, before["inv"] + 1)
        assert torch.equal(hat, ntt_cuda.plain_ntt(a, plan))
        assert torch.equal(back, ntt_cuda.plain_intt(hat, plan))
        with pytest.raises(ValueError, match="no scaled inverse"):
            mod.intt(hat, plan, scaled=True)


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_cuda_coeff_sharded_ntt_matches_single_device(cuda_device, S, logp):
    ring = _ring(11, logp, cuda_device)
    pctx, dim = ring.pctx, 3
    ps = np.array(pctx.primes[:dim], dtype=np.uint64)[:, None]
    a = u64_to_torch(np.random.default_rng(S).integers(0, 1 << 62, (dim, 2048),
                                                       dtype=np.uint64) % ps, cuda_device)
    mesh = _virtual(cuda_device, 1, S)
    splan, C = pmesh._basis_consts(mesh, pctx, dim, 2, "a")
    hat = pmesh._ntt_coeff_sharded(mesh, pmesh._scatter(mesh, a, (None, "coeff")), C, "a", splan)
    assert torch.equal(pmesh._gather(mesh, hat, (None, "coeff")), ring.ntt_f(a, dim))
    back = pmesh._intt_coeff_sharded(mesh, hat, C, "a", splan)
    assert torch.equal(pmesh._gather(mesh, back, (None, "coeff")), a)


@pytest.mark.cuda
def test_cuda_shard_below_the_kernels_minimum_raises(cuda_device):
    pctx = PolyContext(6, q=1 << 20, dim_cap=2)
    with pytest.raises(ValueError, match="below the CUDA NTT's n = 2\\^4"):
        pmesh._basis_consts(_virtual(cuda_device, 1, 8), pctx, 2, 2, "a")
    pmesh._basis_consts(_virtual(torch.device("cpu"), 1, 8), pctx, 2, 2, "a")    # the twin has no minimum


@pytest.mark.cuda
def test_mesh_of_more_gpus_than_there_are_raises(cuda_device):
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"has {have} CUDA devices"):
        pmesh.make_he_mesh3(have + 1, limb=have + 1)
    assert pmesh.make_he_mesh3(have, limb=have).first_device == torch.device("cuda", 0)


def _run_mesh(eng, keys_from):
    """mul_rs, rot, conj and both hoisted gemv routes; the keys are made by
    the single-device engine and shared."""
    A = np.random.default_rng(16).random(16) + 0j
    k = keys_from
    plan = linalg.HoistedGemvPlan(eng, A)
    bank = {r: k["rk"][r] for r in k["rk"] if r < plan.n1 or r % plan.n1 == 0}
    ct = k["ct"]
    out = dict(mul_rs=eng.mul_rs(ct, ct, k["rlk"]), rot=eng.rot(ct, 1, k["rk"]),
               conj=eng.conj(ct, k["ck"]), full=linalg.gemv_hoisted_full(eng, plan, ct, k["rk"]),
               bsgs=linalg.gemv_hoisted(eng, plan, ct, bank))
    assert plan.fallbacks == 0
    return out, A.reshape(4, 4) @ k["m"]


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1), (1, 8, 1)])
def test_cuda_mesh_engine_matches_single_device(cuda_device, shape, logp):
    """MeshCKKS on a virtual mesh of the card against CKKS on the card, on
    the same keys: bit-equal ciphertexts, the local stages on this chain's
    kernel and none of the scaled-inverse form in the sharded programs."""
    ctx = HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30, logp=logp)
    eng = CKKS(ctx, rng=Surf(), device=cuda_device, hoist_bits=100)
    pk, sk = eng.keypair()
    m = np.random.default_rng(9).random(4) + 0j
    keys = dict(rlk=eng.genrlk(sk), ck=eng.genck(sk), rk=eng.genrk(sk), m=m,
                ct=eng.enc_pk(eng.ecd(m), pk))
    want, Av = _run_mesh(eng, keys)
    mesh = _virtual(cuda_device, *shape[:2], shape[2])
    meng = MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=100)
    assert meng.device == mesh.first_device and meng.device.type == "cuda"
    mine, other = ((ntt_cuda.LAUNCHES, ntt_cuda32.LAUNCHES32) if logp == 59
                   else (ntt_cuda32.LAUNCHES32, ntt_cuda.LAUNCHES))
    before, before_other = dict(mine), dict(other)
    got, _ = _run_mesh(meng, keys)
    torch.cuda.synchronize()
    assert mine["fwd"] > before["fwd"] and mine["inv"] >= before["inv"] + 8 * 6
    assert other == before_other
    assert {key[0] for key in meng._mesh_jit} == {"mul_rs", "rot", "gemvstep"}
    for name in want:
        assert got[name].c0.is_cuda
        assert torch.equal(got[name].c0, want[name].c0), name
        assert torch.equal(got[name].c1, want[name].c1), name
    assert np.max(np.abs(eng.dcd(eng.dec(got["full"], sk)) - Av)) < 1e-5
    assert (mesh.traffic["psum"][0] > 0) == (shape[0] > 1)     # one limb shard sums nothing
    assert mesh.traffic["ppermute"][0] > 0


# -- the copy path: a mesh of the card and the host; a mesh of two processes --

from chip_smoke import first_difference, mixed_devices      # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_mesh_of_card_and_host_matches_single_device(cuda_device, logp):
    """(2,2,2) with position (l, c, b) on the card when l + c is even, else on
    the host: every limb psum and coefficient swap, and half of each scatter
    and gather, is a copy between the two (the card's blocks through the
    kernel, the host's through the twin).  Bit-equal to CKKS on the card."""
    ctx = HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30, logp=logp)
    eng = CKKS(ctx, rng=Surf(), device=cuda_device, hoist_bits=100)
    pk, sk = eng.keypair()
    m = np.random.default_rng(9).random(4) + 0j
    keys = dict(rlk=eng.genrlk(sk), ck=eng.genck(sk), rk=eng.genrk(sk), m=m,
                ct=eng.enc_pk(eng.ecd(m), pk))
    want, _ = _run_mesh(eng, keys)
    mesh = pmesh.make_he_mesh3(8, limb=2, coeff=2, devices=mixed_devices(cuda_device, 2, 2, 2))
    assert {mesh.device(p).type for p in mesh.positions} == {"cuda", "cpu"}
    meng = MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=100)
    assert meng.device.type == "cuda"
    got, _ = _run_mesh(meng, keys)
    for name in want:
        for half in ("c0", "c1"):
            a, b = getattr(got[name], half), getattr(want[name], half)
            assert a.is_cuda and torch.equal(a, b), (name, half, first_difference(a, b))
    t = mesh.traffic_by_kind
    assert all(t[c]["device"][1] > 0 for c in ("psum", "ppermute", "scatter", "gather"))
    assert t["psum"]["view"][0] == 0 and t["ppermute"]["view"][0] == 0


@pytest.mark.cuda
def test_cuda_two_process_mesh_over_gloo(cuda_device):
    """gpqhe_tpu_torch.parallel.mp_mul_rs with both ranks on the card over
    gloo (every message staged through host memory), both layouts."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-m", "gpqhe_tpu_torch.parallel.mp_mul_rs",
                        "--device=cuda", "--backend=gloo", "--logn=9", "--logq=120",
                        "--mesh=2x2x2,1x4x2", "--timeout=300"],
                       cwd=root, capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}"
    assert p.stdout.splitlines()[-1].startswith("mp_mul_rs: PASS")
    lines = [json.loads(t) for t in p.stdout.splitlines() if t.startswith("{")]
    assert len(lines) == 4
    for ln in lines:
        assert all(ln["equal"].values()) and ln["device"] == "cuda:0"
        assert ln["launches"]["u64"]["fwd"] > 0 and ln["launches"]["u64"]["inv"] > 0
        assert not any(ln["launches"]["u32"].values())
        kinds = [k for t in ln["traffic"].values() for k in t.values()]
        assert sum(k["process"][1] for k in kinds) > 0 and sum(k["staged"][1] for k in kinds) > 0


# -- the rest of the JAX suite on the card: the logp=9 chain, the exact oracle,
# -- full packing (the same cases as chip_smoke.py's suite phase) --------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_u32_kernel_on_the_logp9_chain(cuda_device, mode):
    """tests/test_crt_mode.py's chain: the u32 kernel on 10-11-bit primes at
    n=2^4, [3, 16] and [2, 3, 16], inputs up to p - 1, torch.equal to the twin."""
    ring = crt_chain_ring(cuda_device)
    assert ring.ntt_mod is ntt_cuda32
    ps = np.array(ring.pctx.primes[:3], dtype=np.uint64)[:, None]
    for shape in ((3, 16), (2, 3, 16)):
        host = np.random.default_rng(len(shape)).integers(0, 1 << 62, shape, dtype=np.uint64) % ps
        host[..., :2] = ps - np.uint64(1)
        a = u64_to_torch(host, cuda_device)
        before, before_other = dict(ntt_cuda32.LAUNCHES32), dict(ntt_cuda.LAUNCHES)
        got = (ring.ntt_f(a, 3) if mode == "fwd"
               else ring.ntt_i(a, 3, scale_phatinv=mode == "inv_scaled"))
        torch.cuda.synchronize()
        assert ntt_cuda32.LAUNCHES32[mode] == before[mode] + 1
        assert ntt_cuda.LAUNCHES == before_other
        assert torch.equal(got, _twin(a, ring.ba(3), mode))


@pytest.mark.cuda
def test_cuda_logp9_chain_exact_at_every_dim(cuda_device):
    before = dict(ntt_cuda32.LAUNCHES32)
    out = crt_chain_case(crt_chain_ring(cuda_device))
    assert sorted(out) == [1, 2, 3, 4, 5, 6]
    assert all(all(v.values()) for v in out.values()), out
    assert all(ntt_cuda32.LAUNCHES32[k] >= before[k] + 6 for k in MODES)


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("case", ["kat", "ladder"])
def test_cuda_exact_oracle(cuda_device, case, logp):
    """tests/test_kat.py on the card: every ciphertext of the KAT sequence
    (logn=4) or of the ladder sweep (logn=5, L=20) limb-equal to the oracle."""
    orc = oracle_module()
    ring, seq = ((orc.KAT_RING, orc.kat_sequence) if case == "kat"
                 else (orc.LADDER_RING, orc.ladder_sweep))
    ctx = HeContext(**ring, logp=logp)
    eng = CKKS(ctx, rng=Surf(), device=cuda_device)
    res = seq(eng, orc.Oracle(ctx))
    assert all(c.c0.is_cuda for _, c, _ in res)
    bad = {name: orc.first_mismatch(eng, c, o) for name, c, o in res}
    assert not any(bad.values()), {k: v for k, v in bad.items() if v}


def _equal_ct(a, b):
    return a.c0.is_cuda and not any(equal_cts(a, b).values())


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("slots", [256, 8])
def test_cuda_gemv_packing_matches_cpu(cuda_device, slots, logp):
    """Hoisted gemv at full packing (slots=256) and at slots=8 on the card,
    torch.equal to the CPU port on the same keys."""
    c = gemv_packing_case(logp, slots, device=cuda_device)
    t = gemv_packing_case(logp, slots, device="cpu")
    assert all(torch.equal(c["rk"][r].p0hat.cpu(), t["rk"][r].p0hat) for r in t["rk"])
    assert _equal_ct(c["out"], t["out"])
    assert c["fallbacks"] == 0 and c["diff"] < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_full_packing_c2s_matches_cpu(cuda_device, logp):
    c = c2s_packing_case(logp, device=cuda_device)
    t = c2s_packing_case(logp, device="cpu")
    assert all(torch.equal(c["rk"][r].p0hat.cpu(), t["rk"][r].p0hat) for r in t["rk"])
    assert _equal_ct(c["ct0"], t["ct0"]) and _equal_ct(c["ct1"], t["ct1"])
    assert c["u_diff"] < 1e-9 and max(c["diffs"]) < 1e-5
