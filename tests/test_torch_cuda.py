"""The port on an NVIDIA GPU: the two CUDA NTT kernels (u64 words for the
59-bit chain, u32 words for a logp=29 chain) against the plain torch twin,
and the CUDA engine against the CPU engine, bit for bit, on both chains.

Every test here needs the card and skips without one.  The file imports
neither jax nor gpqhe_tpu, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(--noconftest: tests/conftest.py configures jax for the JAX package's tests.)
"""

import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (GRAPH_ENGINES, GRAPH_INPUTS, GRAPH_OPS, HOISTED,  # the repository
                        bootstrap_cases, c2s_packing_case, crt_chain_case,   # root is on
                        crt_chain_ring, equal_cts, gemv_packing_case,        # sys.path
                        graph_case, graph_check, oracle_module)
from gpqhe_tpu_torch import CKKS, HeContext, Surf         # (python -m pytest)
from gpqhe_tpu_torch import bootstrap as bs
from gpqhe_tpu_torch.algo import linalg, nonlinear
from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import ntt as twin
from gpqhe_tpu_torch.ops import ntt_cuda, ntt_cuda32
from gpqhe_tpu_torch.ops.modmath import u64_to_torch
from gpqhe_tpu_torch.ring import sample
from gpqhe_tpu_torch.ring.poly import RingEngine
from gpqhe_tpu_torch.utils import graphs

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


# ---------------------------------------------------------------------------
# the elementwise kernels (csrc/modmath.cu, rns.cu, limbs.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("logn,logp", [(14, 59), (14, 29), (15, 59)])
def test_cuda_elementwise_kernels_match_plain(cuda_device, logn, logp):
    """Every entry of the modmath, decompose, CRT-lift and limb kernels
    torch.equal to its plain torch version on the same CUDA tensors, at the
    paths' shapes of the ring (logn=14: dims 16/24/26 or 31/47/50; logn=15:
    31/47/48; batch 8) on edge words; digit_split's f64 estimate within a
    relative 2^-45 (summed in another order)."""
    from chip_smoke import ew_compare, ew_counters, elementwise_cases
    before = ew_counters()
    cases = elementwise_cases(logn, logp, cuda_device)
    for entry, entry_cases in cases.items():
        for case in entry_cases:
            got, want = case["kern"](), case["plain"]()
            torch.cuda.synchronize()
            eq, err, extra = ew_compare(got, want)
            assert eq, (entry, case["shape"], err, extra)
    after = ew_counters()
    assert all(after[e] > before[e] for e in cases), {e: after[e] - before[e] for e in cases}


_EDGE = {}


def _edge_cases(device):
    from chip_smoke import elementwise_edge_cases
    if str(device) not in _EDGE:
        _EDGE[str(device)] = elementwise_edge_cases(device)
    return _EDGE[str(device)]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["limbs_add", "limbs_sub", "limbs_neg", "limbs_add_scalar_bit",
                                   "limbs_select", "limbs_geq_const", "limbs_mask_bits",
                                   "limbs_rshift_round", "limbs_rshift_round_mask",
                                   "limbs_from_digits16", "crt_lift", "decompose",
                                   "crt_digit_split"])
def test_cuda_row_kernels_at_tile_edges(cuda_device, entry):
    """K7, the CRT lift, decompose and the digit split at the edges of their
    designs (chip_smoke.py's elementwise_edge_cases): K = 1 .. 3071 limbs
    around whole chunks of 32, rows not a multiple of a block's, constant,
    broadcast (two leading rows), row-strided and limb-strided operands
    through cuda_build.strides3, bool and int64 row bits, the lift at one,
    two and four chunks; decompose around its tiles of primes and staged
    chunks of limbs, at every src_bits edge, on the three widths of prime;
    the digit split around its blocks of coefficients and warps of primes,
    on strided, broadcast and misaligned residues; each launch torch.equal
    to the plain version on the same CUDA tensors (the split's f64 estimate
    within a relative 2^-45: chip_smoke.ew_compare)."""
    from chip_smoke import ew_compare, ew_counters
    cases = [c for c in _edge_cases(cuda_device) if c["entry"] == entry]
    before = ew_counters()[entry]
    for case in cases:
        got, want = case["kern"](), case["plain"]()
        torch.cuda.synchronize()
        assert ew_compare(got, want)[0], case["shape"]
    assert ew_counters()[entry] > before


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["modmath_mulmod", "modmath_mont_mul", "modmath_addmod",
                                   "modmath_submod", "modmath_to_mont"])
def test_cuda_modmath_at_the_edges_of_its_design(cuda_device, entry):
    """K5's elementwise kernel at the edges of its design (chip_smoke.py's
    MODMATH_EDGES): rows and n that are not a multiple of a thread's 4 words
    or a block's 1024, views one word off 16-byte alignment, stride-0
    operands on each axis, the key bank's row and column slices, A past
    65535, the three widths of prime, mont_mul on any u64 words; each
    launch torch.equal to the plain version on the same CUDA tensors."""
    from chip_smoke import ew_compare, ew_counters
    cases = [c for c in _edge_cases(cuda_device) if c["entry"] == entry]
    before = ew_counters()[entry]
    for case in cases:
        got, want = case["kern"](), case["plain"]()
        torch.cuda.synchronize()
        assert ew_compare(got, want)[0], case["shape"]
    assert ew_counters()[entry] >= before + len(cases)


@pytest.mark.cuda
def test_cuda_elementwise_kernels_reject_bad_operands(cuda_device):
    from gpqhe_tpu_torch.ops import limbs, modmath, rns
    x = torch.zeros((3, 16), dtype=torch.int64, device=cuda_device)
    p = torch.full((3, 1), 17, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        modmath.mulmod(x.to(torch.int32), x.to(torch.int32), p, p, p)
    with pytest.raises(ValueError):
        modmath.addmod(x, x, x)              # a "constant" that varies along n
    with pytest.raises(ValueError):
        modmath.addmod(x, x, p.cpu())        # operands on two devices
    w = torch.zeros((3, 3), dtype=torch.int64, device=cuda_device).t()   # not contiguous
    with pytest.raises(ValueError):
        rns.decompose_core(torch.zeros((16, 6), dtype=torch.int64, device=cuda_device),
                           p[:, 0], p[:, 0], w)
    with pytest.raises(ValueError):
        limbs.add(x, x.to(torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ys", [((3, 16, 64), (2, 3, 16, 64)), ((3, 1, 16, 64), (3, 2, 16, 64)),
                                   ((2, 1, 16, 64), (1, 3, 16, 64))])
def test_cuda_elementwise_kernels_read_broadcast_operands(cuda_device, xs, ys):
    """An operand broadcast along leading axes whose strides do not collapse
    into one (a [3, 16, n] against [2, 3, 16, n], a [3, 1, ...] against
    [3, 2, ...]) is copied in full and read right: mulmod and the limb add
    equal their plain versions."""
    from gpqhe_tpu_torch.ops import cuda_build, limbs, modmath, rns
    rng = np.random.default_rng(11)
    pctx = PolyContext(6, q=1 << 20, dim_cap=16)
    ba = rns.make_basis_arrays(pctx, 16, "cpu")
    ps = np.asarray(pctx.primes[:16], dtype=np.uint64)[:, None]
    x = torch.from_numpy((rng.integers(0, 1 << 63, size=xs, dtype=np.uint64) % ps).view(np.int64))
    y = torch.from_numpy((rng.integers(0, 1 << 63, size=ys, dtype=np.uint64) % ps).view(np.int64))
    p, pinv, r2 = ba.ps[:, None], ba.pinv[:, None], ba.r2[:, None]
    want = modmath.plain_mulmod(x, y, p, pinv, r2)
    copies = cuda_build.COPIES["operands"]
    got = modmath.mulmod(*(t.to(cuda_device) for t in (x, y, p, pinv, r2)))
    assert torch.equal(got.cpu(), want)
    a = torch.from_numpy(rng.integers(0, 1 << 32, size=xs[:-2] + (64, 5)).astype(np.int64))
    b = torch.from_numpy(rng.integers(0, 1 << 32, size=ys[:-2] + (64, 5)).astype(np.int64))
    assert torch.equal(limbs.add(a.to(cuda_device), b.to(cuda_device)).cpu(), limbs.plain_add(a, b))
    assert cuda_build.COPIES["operands"] > copies


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_keyswitch_path_launches_the_elementwise_kernels(cuda_device, logp):
    """The key-switch path on the card goes through K4-K7 (each kernel's
    launch count grows) and none of them on the host engine."""
    from chip_smoke import ew_by_kernel, ew_counters
    before = ew_by_kernel(ew_counters())
    _run_keyswitch(cuda_device, logp)
    after = ew_by_kernel(ew_counters())
    assert all(after[k] > before[k] for k in after), (before, after)
    mid = after
    _run_keyswitch(torch.device("cpu"), logp)
    assert ew_by_kernel(ew_counters()) == mid


# ---------------------------------------------------------------------------
# K8 (csrc/ntt4.cu): the four-step NTT's fused stage, and the engine on
# ntt_impl="matmul"
# ---------------------------------------------------------------------------

from chip_smoke import (NTT4_PATH, ntt4_compare, ntt4_edge_cases, ntt4_input,  # noqa: E402
                        ntt4_max_sums)
from gpqhe_tpu_torch.ops import ntt4, ntt4_cuda  # noqa: E402

_ntt4_plans = {}


def _ntt4_plan(pctx, dim, device, key):
    if key not in _ntt4_plans:
        _ntt4_plans[key] = ntt4.make_ntt4_plan(pctx, dim, device)
    return _ntt4_plans[key]


@pytest.mark.cuda
@pytest.mark.parametrize("logp,mode,shape", [(logp, mode, shape) for logp in (59, 29)
                                             for mode, shape in NTT4_PATH[logp]])
def test_cuda_ntt4_matches_plain_at_the_paths_shapes(cuda_device, logp, mode, shape):
    """Each of a transform's two stage launches, and the whole transform, at
    the main path's shapes (logn=14) torch.equal to the plain versions, and
    every launch counted."""
    plan = _ntt4_plan(PolyContext(14, 1 << 438, logp=logp), shape[-1], cuda_device,
                      (logp, 14, shape[-1]))
    ps = np.array(plan.ps.cpu().numpy(), dtype=np.uint64)[:, None]
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = u64_to_torch(rng.integers(0, 1 << 62, shape + (1 << 14,), dtype=np.uint64) % ps,
                     cuda_device)
    before = dict(ntt4_cuda.LAUNCHES)
    equal, steps, _ = ntt4_compare(x, plan, mode)
    torch.cuda.synchronize()
    assert equal and [s[0] for s in steps] == ["ntt4_stage"] * 2
    assert ntt4_cuda.LAUNCHES["stage"] == before["stage"] + 4       # two stages, twice


@pytest.mark.cuda
@pytest.mark.parametrize("case", ntt4_edge_cases(), ids=lambda c: c["id"])
def test_cuda_ntt4_at_the_edges(cuda_device, case):
    plan = _ntt4_plan(PolyContext(case["logn"], **case["ctx"]), case["dim"], cuda_device,
                      (case["logp"], case["logn"], case["dim"]))
    x = ntt4_input(case, plan, cuda_device)
    equal, _, out = ntt4_compare(x, plan, case["mode"])
    assert equal
    if case["mode"] == "fwd":
        assert torch.equal(ntt4.kernel_intt4(out, plan), x)


@pytest.mark.cuda
@pytest.mark.parametrize("P8", [2, 4, 8])
def test_cuda_ntt4_stage_at_the_largest_digit_sums(cuda_device, P8):
    """A stage with K = 256 and every byte 255: the s32 sums at their bound."""
    plan = _ntt4_plan(PolyContext(16, q=1 << 20, dim_cap=8), 3, cuda_device, (59, 16, 3))
    args = ntt4_max_sums(plan, P8, cuda_device)
    assert torch.equal(ntt4_cuda.stage(*args), ntt4.plain_ntt4_stage(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fwd", "inv_scaled"])
def test_cuda_ntt4_at_a_contraction_of_256(cuda_device, mode):
    """logn=16 (n1 = n2 = 256) at the path's batch: both stages contract
    over K = 256, four blocks of rows a slab, on random residues."""
    plan = _ntt4_plan(PolyContext(16, q=1 << 20, dim_cap=8), 3, cuda_device, (59, 16, 3))
    case = dict(logp=59, logn=16, lead=(4,), fill="random")
    x = ntt4_input(case, plan, cuda_device)
    equal, steps, _ = ntt4_compare(x, plan, mode)
    torch.cuda.synchronize()
    assert equal and [a[3:5] for _, a, _ in steps] == [(256, 256)] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_matmul_engine_mul_rs_equals_butterfly(cuda_device, logp):
    """The same stream through both backends at the main path's ring: the
    keys differ (another NTT order), mul_rs's ciphertext is the same, and
    the matmul engine launches K8 and no butterfly NTT."""
    ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50, logp=logp)
    out = {}
    for impl in ("butterfly", "matmul"):
        eng = CKKS(ctx, rng=Surf(), device=cuda_device, ntt_impl=impl)
        pk, sk = eng.keypair()
        rlk = eng.genrlk(sk)
        m1, m2 = (sample.sample_z01vec(eng.rng, ctx.slots) for _ in range(2))
        ct1, ct2 = eng.enc_pk(eng.ecd(m1), pk), eng.enc_pk(eng.ecd(m2), pk)
        counts = (dict(ntt_cuda.LAUNCHES), dict(ntt_cuda32.LAUNCHES32), dict(ntt4_cuda.LAUNCHES))
        ct = eng.mul_rs(ct1, ct2, rlk)
        torch.cuda.synchronize()
        after = (ntt_cuda.LAUNCHES, ntt_cuda32.LAUNCHES32, ntt4_cuda.LAUNCHES)
        out[impl] = (ct, rlk, [sum(a.values()) - sum(b.values()) for a, b in zip(after, counts)],
                     np.max(np.abs(eng.dcd(eng.dec(ct, sk)) - m1 * m2)))
    (cb, kb, nb, db), (cm, km, nm, dm) = out["butterfly"], out["matmul"]
    assert torch.equal(cb.c0, cm.c0) and torch.equal(cb.c1, cm.c1)
    assert (cb.l, cb.nu, cb.B) == (cm.l, cm.nu, cm.B)
    assert not torch.equal(kb.p0hat, km.p0hat)
    assert db < 1e-5 and dm < 1e-5
    assert nb[2] == 0 and nb[0] + nb[1] == 4          # four transforms, one launch each
    assert nm[0] == nm[1] == 0 and nm[2] == 8          # two stages each


# -- the engine programs as CUDA graphs (utils/graphs.py) ---------------------

_GRAPHS = {}


def _graph_case(device, logp, impl):
    """graph_case at the main path's ring, with its fresh input sets, once
    per (chain, backend)."""
    if (logp, impl) not in _GRAPHS:
        case = graph_case(logp, impl, device=device)
        case["inputs"] = [case["fresh"](seed) for seed in range(GRAPH_INPUTS)]
        _GRAPHS[logp, impl] = case
    return _GRAPHS[logp, impl]


@pytest.mark.cuda
@pytest.mark.parametrize("logp,impl,op", [(logp, impl, op) for logp, impl in GRAPH_ENGINES
                                          for op in GRAPH_OPS
                                          if impl != "matmul" or op not in HOISTED])
def test_cuda_graphed_program_equals_eager(cuda_device, logp, impl, op):
    """Each op's programs as CUDA graphs, torch.equal to the same programs
    under graphs.disabled() at the first call and at replays over fresh
    inputs, no result overwritten or shared, the launch counters of a replay
    equal to an eager call's (chip_smoke.graph_check)."""
    case = _graph_case(cuda_device, logp, impl)
    r = graph_check(case["ops"][op], case["inputs"], f"{op} logp={logp} {impl}")
    g = case["eng"].ring.graphs
    assert r["launches"] > 0 and g.captures > 0 and g.replays > 0


@pytest.mark.cuda
def test_cuda_mul_rs_replays_one_graph(cuda_device):
    """After its first call a mul_rs is one replay of its level's graph:
    no capture, one replay, one graph under the program's key."""
    case = _graph_case(cuda_device, 59, "butterfly")
    eng, x = case["eng"], case["inputs"][0]
    rlk = case["keys"][2]
    eng.mul_rs(x["ct1"], x["ct2"], rlk)
    g = eng.ring.graphs
    before = (g.captures, g.replays)
    eng.mul_rs(x["ct2"], x["ct1"], rlk)
    assert (g.captures, g.replays) == (before[0], before[1] + 1)
    assert len(eng._fns[("he_mul_rs", eng.ctx.L)].graphs) == 1
    assert isinstance(g.capture, graphs.CudaGraphs)


@pytest.mark.cuda
def test_cuda_capture_runs_with_the_collector_off(cuda_device):
    """The garbage collector is off while a stream captures (a graph it
    freed then could not be destroyed), and on again after."""
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x + 1
    prog = graphs.Graphs().program(fn, ("collector",))
    prog(torch.zeros(4, device=cuda_device))
    assert seen == [True, False] and gc.isenabled()


@pytest.mark.cuda
def test_cuda_a_failing_capture_raises(cuda_device):
    """A program that reads the device back cannot be captured: the call
    raises (no fallback), and the card and the eager program go on."""
    g = graphs.Graphs()
    prog = g.program(lambda x: x + x.sum().item(), ("syncs",))
    x = torch.arange(4, device=cuda_device)
    with pytest.raises(RuntimeError, match="capture of program"):
        prog(x)
    assert g.captures == 0 and not prog.graphs
    with graphs.disabled():
        assert torch.equal(prog(x), x + 6)


# -- the mesh's sharded programs as CUDA graphs (parallel/mesh.py) -----------

from chip_smoke import (MESH_HEADS, graph_same, mesh_graphed,  # noqa: E402
                        mesh_replays_match)
from gpqhe_tpu_torch.scheme.types import limbs_to_torch      # noqa: E402

_MESHES = {}


def _mesh_case(device, logp):
    """MeshCKKS on a virtual (2,2,2) mesh of the card and CKKS on the card,
    on the same keys, with three input sets and the ops of MESH_HEADS,
    once per chain."""
    if logp not in _MESHES:
        ctx = HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30, logp=logp)
        eng = CKKS(ctx, rng=Surf(), device=device, hoist_bits=100)
        pk, sk = eng.keypair()
        rlk, ck, rk = eng.genrlk(sk), eng.genck(sk), eng.genrk(sk)
        mesh = _virtual(device, 2, 2, 2)
        meng = MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=100)
        rng = np.random.default_rng(logp)
        A = rng.random(16) + 1j * rng.random(16)
        plans = {e: linalg.HoistedGemvPlan(e, A) for e in (eng, meng)}
        inputs = [{k: eng.enc_pk(eng.ecd(rng.random(4) + 1j * rng.random(4)), pk)
                   for k in ("ct", "ct2")} for _ in range(3)]

        def ops(e):
            return {"mul_rs": lambda x: e.mul_rs(x["ct"], x["ct2"], rlk),
                    "rot": lambda x: e.rot(x["ct"], 1, rk), "conj": lambda x: e.conj(x["ct"], ck),
                    "gemv_full": lambda x: linalg.gemv_hoisted_full(e, plans[e], x["ct"], rk)}
        _MESHES[logp] = dict(mesh=mesh, meng=meng, single=ops(eng), sharded=ops(meng),
                             inputs=inputs)
    return _MESHES[logp]


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("op", list(MESH_HEADS))
def test_cuda_mesh_op_graphed_equals_eager(cuda_device, logp, op):
    """On a virtual mesh of the card each sharded program is a CUDA graph:
    the op torch.equal to itself under graphs.disabled() at the capture and
    at replays (chip_smoke.graph_check) and to the single-device engine on
    every input set; three replays count the launches and the mesh traffic
    of three eager calls."""
    c = _mesh_case(cuda_device, logp)
    fn = c["sharded"][op]
    r = graph_check(fn, c["inputs"], f"mesh {op} logp={logp}")
    assert r["launches"] > 0
    for x in c["inputs"]:
        assert graph_same(fn(x), c["single"][op](x))
    assert c["mesh"].graphable and mesh_graphed(c["meng"], op, c["inputs"][0]["ct"].l)
    gains = mesh_replays_match(fn, c["inputs"], c["mesh"], f"{op} logp={logp}")
    assert gains["traffic"]["psum"][0] > 0 and gains["traffic"]["ppermute"][0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_sharded_poly_mul_3d_graphed(cuda_device, logp):
    """build_sharded_poly_mul_3d on a virtual (2,2,2) mesh of the card, in
    the mesh's own graphs: its capture and a replay torch.equal to eager
    and to RingEngine.poly_mul on the card, pair by pair."""
    pctx = PolyContext(9, q=1 << 100, logp=logp, dim_cap=8)
    mesh = _virtual(cuda_device, 2, 2, 2)
    f = pmesh.build_sharded_poly_mul_3d(pctx, 8, 4, 128, 4, mesh)
    ring = RingEngine(pctx, device=cuda_device)
    rng = np.random.default_rng(logp)
    sets = []
    for _ in range(2):
        w = rng.integers(0, 1 << 32, (2, 2, 512, 4), dtype=np.uint32)
        w[..., -1] &= 0xF
        sets.append([limbs_to_torch(x, cuda_device) for x in w])
    got = [f(a, b) for a, b in sets]
    with graphs.disabled():
        want = [f(a, b) for a, b in sets]
    assert isinstance(f, graphs.Program) and len(f.graphs) == 1 and mesh.graphs.replays == 1
    for (a, b), g, e in zip(sets, got, want):
        assert torch.equal(g, e)
        for i in range(2):
            assert torch.equal(g[i], ring.poly_mul(a[i], b[i], 8, 128, 4))
