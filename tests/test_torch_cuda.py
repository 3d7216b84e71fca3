"""The port on an NVIDIA GPU: the two CUDA NTT kernels (u64 words for the
59-bit chain, u32 words for a logp=29 chain) against the plain torch twin
and against the first-design kernels kept in the same libraries (entries
gpqhe_ntt_v1 / gpqhe_ntt32_v1, bound by chip_smoke.py), and the CUDA engine
against the CPU engine, bit for bit, on both chains.

Every test here needs the card and skips without one.  The file imports
neither jax nor gpqhe_tpu, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(--noconftest: tests/conftest.py configures jax for the JAX package's tests.)
"""

import numpy as np
import pytest
import torch

from chip_smoke import v1_transform    # the repository root is on sys.path (python -m pytest)
from gpqhe_tpu_torch import CKKS, HeContext, Surf
from gpqhe_tpu_torch.algo import linalg
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
    kernel and none of the other's, torch.equal to the twin and to v1."""
    ring = _ring(logn, logp, device)
    kernel, mine, other = (("ntt", ntt_cuda.LAUNCHES, ntt_cuda32.LAUNCHES32) if logp == 59
                           else ("ntt32", ntt_cuda32.LAUNCHES32, ntt_cuda.LAUNCHES))
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
    old = v1_transform(kernel, a, ring.ntt_plan(dim), mode)
    torch.cuda.synchronize()
    assert mine[mode] == before[mode] + 1              # v1 is not the package's route
    assert torch.equal(got, old)


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
