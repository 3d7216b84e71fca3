"""The port on an NVIDIA GPU: the two CUDA NTT kernels (u64 words for the
59-bit chain, u32 words for a logp=29 chain) against the plain torch twin,
and the CUDA engine against the CPU engine, bit for bit, on both chains.

Every test here needs the card and skips without one.  The file imports
neither jax nor gpqhe_tpu, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(--noconftest: tests/conftest.py configures jax for the JAX package's tests.)
"""

import contextlib
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_cases import (DIGITS16, GRAPH_ENGINES, GRAPH_INPUTS, GRAPH_OPS,  # tests/ is on
                         HOISTED, LIFT16, LIFT_WIDE16, NTT16, bootstrap_cases,  # sys.path
                         c2s_packing_case, crt_chain_case, crt_chain_ring, equal_cts,
                         full_width_checks, gemv_packing_case, graph_case, graph_check,
                         kernel_ring, oracle_module)
from gpqhe_tpu_torch import CKKS, HeContext, Surf         # the root too (python -m pytest)
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape", NTT16, ids=[f"{m} {list(s)}" for m, s in NTT16])
def test_cuda_kernel_at_the_n16_rings_shapes(cuda_device, mode, shape):
    """logn=16 on the 58-level chain (gpubench's ckks-n16-q1751): the u64
    kernel's (8, 8) passes at the product's basis [4, 60, 2^16] and the key
    switch's [2, 90, 2^16], forward, inverse and inverse x n^-1 phat^-1, one
    launch each, torch.equal to the twin."""
    dim = shape[-2]
    ring = kernel_ring("ntt", 16, dim)
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


_RING16 = {}
RING16_CASES = ([("decompose", i) for i in range(2)]
                + [("crt_digit_split", i) for i in range(len(DIGITS16))]
                + [("crt_lift", i) for i in range(len(LIFT16))] + [("limbs_fill_rows", 0)])


@pytest.mark.cuda
@pytest.mark.parametrize("entry,i", RING16_CASES, ids=[f"{e} {i}" for e, i in RING16_CASES])
def test_cuda_elementwise_kernels_at_the_n16_rings_shapes(cuda_device, entry, i):
    """torch_cases.py's ring16_cases, which chip_smoke.py's kernels16 phase
    times: decompose
    of [2^16, 55] limbs into 60 primes and, signed, into the key switch's
    90; the digit product at DIGITS16 ([3, 60, 2^16] and [2, 90, 2^16] to
    110 digit sums, the exact [2, 30 of 90, 2^16], scaled, to 114); the lift
    at [2^16, 2K -> K] for K = 46, 88, 57, 147, 167 (exact) and from 90
    primes to 55 limbs (fast); ecd's fill of 8 rows of 55 limbs: each
    torch.equal to its plain version (the digit sums as values mod 2^(16
    kd), the f64 estimate within a relative 2^-45: torch_cases.ew_compare)
    in one launch of its kernel."""
    from torch_cases import ew_compare, ew_counters, ring16_cases
    if "cases" not in _RING16:
        _RING16["cases"] = ring16_cases(cuda_device)
    case = _RING16["cases"][entry][i]
    if entry == "crt_lift":
        assert case["shape"][2] == (LIFT16[i][1] or case["shape"][1] // 2)
    before = ew_counters()
    got = case["kern"]()
    after = ew_counters()
    eq, err, extra = ew_compare(got, case["plain"]())
    assert eq, (entry, case["shape"], err, extra)
    assert after[entry] == before[entry] + 1


# -- ckks-n16-q1751 past level 37: the lift at five and six chunks -----------

_N16 = {}


@pytest.mark.cuda
@pytest.mark.parametrize("dim,k_out", LIFT_WIDE16, ids=[f"{d}-{k}" for d, k in LIFT_WIDE16])
def test_cuda_wide_lift_equals_the_plain_lift(cuda_device, dim, k_out):
    """The lift past four chunks of 32 limbs on [2^16, 2K] int64 digit sums
    of random residues: exact at 129, 147 and 167 limbs (69, 79, 90
    primes), fast from 104 primes to 192 limbs; one launch of
    rns_lift_kernel at five or six chunks, counted in LAUNCHES["lift"] and
    rns.LIFT_WIDE, torch.equal to plain_lift on the same tensors."""
    from torch_cases import lift16_case
    from gpqhe_tpu_torch.ops import rns, rns_cuda
    if "pctx" not in _N16:
        _N16["pctx"] = PolyContext(16, q=1 << 20, dim_cap=max(d for d, _ in LIFT_WIDE16))
    pctx = _N16["pctx"]
    ba = rns.make_basis_arrays(pctx, dim, cuda_device)
    shape, kern, plain, _, _ = lift16_case(pctx, ba, k_out, np.random.default_rng(dim),
                                           cuda_device)
    assert 128 < shape[2] <= rns_cuda.MAX_LIMBS and shape[2] in (129, 147, 167, 192)
    launches, wide = rns_cuda.LAUNCHES["lift"], rns.LIFT_WIDE["calls"]
    got = kern()
    torch.cuda.synchronize()
    assert rns_cuda.LAUNCHES["lift"] == launches + 1 and rns.LIFT_WIDE["calls"] == wide + 1
    assert torch.equal(got, plain())


def _n16_chain(device):
    """gpubench's n16.circuit on the card, once a process: the engine of
    ckks-n16-q1751-circuit, ckks-n16-q1751's ring (HeContext(16, 2^1751, 4,
    2^30)), a secret and its
    relinearization key, x: slots in the unit box encrypted and taken down
    to level 40, and w[l] for l = 40 .. 2: slots e^(i theta) encrypted and
    taken down to level l."""
    if "eng" not in _N16:
        ctx = HeContext(logn=16, q=1 << 1751, slots=4, Delta=1 << 30)
        eng = CKKS(ctx, rng=Surf(), device=device)
        _, sk = eng.keypair()
        rng = np.random.default_rng(16)

        def down(m, level):
            ct = eng.enc_sk(eng.ecd(m), sk)
            while ct.l > level:
                ct = eng.moddown(ct)
            return ct
        mx = rng.uniform(-1, 1, 4) + 1j * rng.uniform(-1, 1, 4)
        mw = {l: np.exp(1j * rng.uniform(0, 2 * np.pi, 4)) for l in range(40, 1, -1)}
        _N16.update(eng=eng, sk=sk, rlk=eng.genrlk(sk), mx=mx, mw=mw, x=down(mx, 40),
                    w={l: down(m, l) for l, m in mw.items()})
    return _N16


def _on_host(x):
    """A ciphertext or switch key with its tensors copied to the host."""
    import dataclasses
    return dataclasses.replace(x, **{f.name: getattr(x, f.name).cpu()
                                     for f in dataclasses.fields(x)
                                     if isinstance(getattr(x, f.name), torch.Tensor)})


@pytest.mark.cuda
def test_cuda_n16_product_at_level_37_takes_the_wide_lift(cuda_device):
    """mul_rs at level 37 of ckks-n16-q1751, where the key switch's bound
    leaves 2 bits below P over its 79 primes, so that it lifts exactly, 147
    limbs (five chunks): LIFT_WIDE rises by one, and the product is
    torch.equal to the CPU twin's of the same ciphertexts under the same
    key."""
    from gpqhe_tpu_torch.ops import rns
    c = _n16_chain(cuda_device)
    eng = c["eng"]
    assert eng.ctx.dim_swk(37) == 79
    x = c["x"]
    while x.l > 37:
        x = eng.moddown(x)
    wide = rns.LIFT_WIDE["calls"]
    got = eng.mul_rs(x, c["w"][37], c["rlk"])
    torch.cuda.synchronize()
    assert rns.LIFT_WIDE["calls"] == wide + 1 and got.l == 36
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        want = CKKS(eng.ctx, rng=Surf(), device=torch.device("cpu")).mul_rs(
            _on_host(x), _on_host(c["w"][37]), _on_host(c["rlk"]))
    finally:
        torch.set_num_threads(1)
    assert torch.equal(got.c0.cpu(), want.c0) and torch.equal(got.c1.cpu(), want.c1)


@pytest.mark.cuda
def test_cuda_n16_chain_from_level_40_to_1(cuda_device):
    """The n16.circuit request on the card: a relinearized product at every
    level from 40 to 1 (39 mul_rs, each a CUDA graph of its own), one of
    them lifting past 128 limbs; the output at level 1 decrypts to x prod
    w_l within the cell's max_err (gpubench/cells/n16.circuit.json)."""
    from gpqhe_tpu_torch.ops import rns
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "gpubench", "cells", "n16.circuit.json")) as f:
        limit = json.load(f)["limits"]["max_err"]
    c = _n16_chain(cuda_device)
    eng, y, want = c["eng"], c["x"], c["mx"]
    wide = rns.LIFT_WIDE["calls"]
    for l in range(40, 1, -1):
        y = eng.mul_rs(y, c["w"][l], c["rlk"])
        want = want * c["mw"][l]
    torch.cuda.synchronize()
    assert y.l == 1 and rns.LIFT_WIDE["calls"] == wide + 1
    err = float(np.max(np.abs(eng.dcd(eng.dec(y, c["sk"])) - want)))
    assert err < limit, err


# the reconstruct at the cells' shapes: (logn, leading axes, primes, rows of
# the stack, k_out (None: the exact path, center=False), scaled): n14's
# mul_rs product and key switch (c to 14 limbs over 24 primes, its exact r
# over the first 8 of them), n15's product and key switch (31 and 47 primes
# to 28 limbs), n16's product and key switch (60 and 90 primes to 55 limbs,
# the exact r over the first 30 of 90: 57 limbs)
RECON_SHAPES = ((14, (3, 8), 16, 16, 14, False), (14, (2, 8), 24, 24, 14, False),
                (14, (2, 8), 8, 24, None, True), (15, (3,), 31, 31, 28, False),
                (15, (2,), 47, 47, 28, False), (16, (3,), 60, 60, 55, False),
                (16, (2,), 90, 90, 55, False), (16, (2,), 30, 90, None, True))


@pytest.mark.cuda
@pytest.mark.parametrize("logn,lead,dim,rows,k_out,scaled", RECON_SHAPES)
def test_cuda_reconstruct_through_the_digit_product(cuda_device, logn, lead, dim, rows, k_out,
                                                    scaled):
    """rns.reconstruct on the card, its digit product one launch of
    rns_cuda.digit_sums (u8 products on the tensor cores), torch.equal to
    the plain reconstruct (16-bit split, f64 matmul, plain lift) on the same
    tensors: the fast path on values within its bound (|value| < 2^(logP -
    3), pre-scaled residues as the key switch's c and mul_rs's product take
    them), the exact path on any residues of a prime slice, scaled.  As a
    CUDA graph, equal to graphs.disabled() at the capture and at a replay,
    each call counted once in LAUNCHES["digit_split"]."""
    from gpqhe_tpu_torch.ops import limbs as lb
    from gpqhe_tpu_torch.ops import rns, rns_cuda
    from gpqhe_tpu_torch.ops.modmath import plain_mont_mul
    rng = np.random.default_rng(logn * 1000 + dim)
    ring = RingEngine(PolyContext(logn, q=1 << 20, dim_cap=rows), device=cuda_device)
    n, plan, ba = 1 << logn, ring.recon(dim), ring.ba(dim)
    kd = min(2 * k_out, plan.ds) if k_out else plan.ds
    if k_out:
        bound = plan.logP - 3
        vals = torch.from_numpy(rng.integers(0, 1 << 32, size=lead + (n, plan.ks))).to(cuda_device)
        vals = lb.plain_mask_bits(vals, bound - 1)
        vals = lb.plain_select(torch.from_numpy(rng.random(lead + (n,)) < 0.5).to(cuda_device),
                               lb.plain_neg(vals), vals)
        c = rns.decompose(vals, ba, ring.weights(dim, plan.ks), src_bits=32 * plan.ks)
        y = plain_mont_mul(c, ba.phatinv_mont[:, None], ba.ps[:, None], ba.pinv[:, None])
    else:
        bound = None
        p = np.asarray(ring.pctx.primes[:rows], dtype=np.uint64)[:, None]
        stack = rng.integers(0, 1 << 63, size=lead + (rows, n), dtype=np.uint64) % p
        y = torch.from_numpy(stack.view(np.int64)).to(cuda_device)[..., :dim, :]
    scale = (ba.phatinv_mont, ba.ps, ba.pinv) if scaled else None
    center = k_out is not None
    want = rns.plain_lift(*rns.plain_digit_partials(y, plan, kd, scale), plan, center, k_out)

    def recon(y):
        return rns.reconstruct(y, ba, plan, center=center, k_out=k_out, bound_bits=bound,
                               pre_scaled=not scaled)
    prog = graphs.Graphs().program(recon, ("reconstruct", logn, dim))
    with graphs.disabled():
        eager = recon(y)
    before = rns_cuda.LAUNCHES["digit_split"]
    first, again = prog(y), prog(y)
    torch.cuda.synchronize()
    assert torch.equal(eager, want)
    assert torch.equal(first, want) and torch.equal(again, want)
    assert rns_cuda.LAUNCHES["digit_split"] == before + 2


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


# -- the reference binary's outputs, the full-width paths, the CLI ----------

def _golden(name):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", name)) as f:
        return {k: np.array([complex(a, b) for a, b in v]) for k, v in json.load(f).items()}


def _chain_launches(logp):
    """(this chain's NTT launch counters, the other kernel's)."""
    return ((ntt_cuda.LAUNCHES, ntt_cuda32.LAUNCHES32) if logp > 29
            else (ntt_cuda32.LAUNCHES32, ntt_cuda.LAUNCHES))


def _reference_logn11(device):
    """tests/test_golden.py on the card: enc, add, mul+rs, conj, rot1 and
    moddown at logn=11 within its tolerances of the binary's decodes, the
    messages the Surf() stream's."""
    from gpqhe_tpu_torch import params
    g = _golden("golden_logn11.json")
    ctx = HeContext(logn=11, q=1 << 48, slots=4, Delta=1 << 20)
    eng = CKKS(ctx, rng=Surf(), device=device)
    pk, sk = eng.keypair()
    rlk, ck, rk = eng.genrlk(sk), eng.genck(sk), eng.genrk(sk)
    m0 = sample.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m0), pk)
    m1 = sample.sample_z01vec(eng.rng, ctx.slots)
    ct2 = eng.enc_pk(eng.ecd(m1), pk)
    assert np.array_equal(m0, g["m0"]) and np.array_equal(m1, g["m1"])
    tol_ks = (params.BLKSIZ + 2) / ctx.Delta
    got = {"enc": (ct1, 1e-9), "add": (eng.add(ct1, ct2), 1e-9),
           "mulrs": (eng.rs(eng.mul(ct1, ct2, rlk)), tol_ks),
           "conj": (eng.conj(ct1.copy(), ck), tol_ks), "rot1": (eng.rot(ct1.copy(), 1, rk), tol_ks),
           "moddown": (eng.moddown(ct1), 1e-9)}
    for name, (ct, tol) in got.items():
        assert ct.c0.is_cuda
        diff = np.max(np.abs(eng.dcd(eng.dec(ct, sk)) - g[name]))
        assert diff < tol, (name, diff, tol)


def _reference_linear(device):
    """The key-switch and hoisted-gemv path at logn=14/logq=438/slots=16/
    Delta=2^50 on both chains: the binary's vector and matrix from the
    Surf() stream (tests/golden/golden_algo_linear.json), its gemv within
    1e-9 on the 59-bit chain; mul_rs, rot, conj, mulpt, a batch's last
    product and the gemv fully hoisted and BSGS (on a bank of the baby steps
    and the giant-step multiples, where the full route declines) within
    1e-5; a batch of 8 torch.equal to 8 mul_rs; no fallback; this chain's
    kernel launched, the other's not; the chains' mul_rs and gemv decodes
    within 1e-9 of each other."""
    g = _golden("golden_algo_linear.json")
    v, A = g["v"], g["A"]
    Av = A.reshape(16, 16) @ v
    decoded = {}
    for logp in (59, 29):
        ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50, logp=logp)
        eng = CKKS(ctx, rng=Surf(), device=device)
        mine, other = _chain_launches(logp)
        before, before_other = dict(mine), dict(other)
        pk, sk = eng.keypair()
        rlk, ck, rk = eng.genrlk(sk), eng.genck(sk), eng.genrk(sk)
        if logp == 59:
            assert np.array_equal(sample.sample_z01vec(eng.rng, 16), v)
            assert np.array_equal(sample.sample_z01vec(eng.rng, 256), A)
        rng = np.random.default_rng(438)
        ms = rng.random((8, 2, 16)) + 1j * rng.random((8, 2, 16))
        m2 = ms[0, 1]
        ct, ct2 = eng.enc_pk(eng.ecd(v), pk), eng.enc_pk(eng.ecd(m2), pk)
        plan = linalg.HoistedGemvPlan(eng, A)
        bank = {r: rk[r] for r in rk if r < plan.n1 or r % plan.n1 == 0}
        cts1 = [eng.enc_pk(eng.ecd(m[0]), pk) for m in ms]
        cts2 = [eng.enc_pk(eng.ecd(m[1]), pk) for m in ms]
        batch = eng.mul_rs_batch(cts1, cts2, rlk)
        for b, x, y in zip(batch, cts1, cts2):
            assert not any(equal_cts(b, eng.mul_rs(x, y, rlk)).values())
        assert linalg.gemv_hoisted_full(eng, plan, ct, rk) is not None
        assert linalg.gemv_hoisted_full(eng, plan, ct, bank) is None
        got = {"mul_rs": (eng.mul_rs(ct, ct2, rlk), v * m2), "rot": (eng.rot(ct, 1, rk), np.roll(v, -1)),
               "conj": (eng.conj(ct, ck), np.conj(v)),
               "mulpt": (eng.rs(eng.mulpt(ct, eng.ecd(m2))), v * m2),
               "batch7": (batch[-1], ms[-1, 0] * ms[-1, 1]),
               "gemv_full": (linalg.gemv(eng, None, ct, rk, plan=plan, hoisted=True), Av),
               "gemv_bsgs": (linalg.gemv_hoisted(eng, plan, ct, bank), Av)}
        decoded[logp] = {k: eng.dcd(eng.dec(c, sk)) for k, (c, _) in got.items()}
        diffs = {k: np.max(np.abs(decoded[logp][k] - want)) for k, (_, want) in got.items()}
        assert all(d < 1e-5 for d in diffs.values()), (logp, diffs)
        assert plan.fallbacks == 0
        assert all(mine[k] > before[k] for k in MODES) and other == before_other
        if logp == 59:
            assert np.max(np.abs(decoded[59]["gemv_full"] - g["gemv"])) < 1e-9
    for k in ("mul_rs", "gemv_full", "gemv_bsgs"):
        assert np.max(np.abs(decoded[59][k] - decoded[29][k])) < 1e-9, k


def _reference_nonlinear(device):
    """algo/nonlinear.py at logn=14/logq=438/slots=4/Delta=2^30, the op
    sequence of tests/test_golden_algo.py: on the 59-bit chain m0 from the
    Surf() stream and he_inv(5), he_exp(5), he_sigmoid, he_log, he_sqrt(6)
    within 1e-4 of the binary's decodes; on logp=29 the same five within
    the per-op CLI's tolerances of the plaintext functions (inv by the
    evaluator's own Goldschmidt recurrence); this chain's kernel launched,
    the other's not."""
    from gpqhe_tpu_torch.algo import nonlinear as nl
    g = _golden("golden_algo_nonlinear.json")
    a = 2j * np.pi / float(1 << 30)
    for logp in (59, 29):
        ctx = HeContext(logn=14, q=1 << 438, slots=4, Delta=1 << 30, logp=logp)
        eng = CKKS(ctx, rng=Surf(), device=device)
        mine, other = _chain_launches(logp)
        before, before_other = dict(mine), dict(other)
        pk, sk = eng.keypair()
        rlk = eng.genrlk(sk)
        m0 = sample.sample_z01vec(eng.rng, ctx.slots)
        assert logp != 59 or np.array_equal(m0, g["m0"])
        m0 = g["m0"]
        msgs = {"inv": m0.real + 0.5, "exp": m0 * a, "sigmoid": m0 / 10,
                "log": m0.real / 100000, "sqrt": m0.real + 0j}
        cts = {k: eng.enc_pk(eng.ecd(np.asarray(m, dtype=np.complex128)), pk)
               for k, m in msgs.items()}
        outs = {"inv": nl.he_inv(eng, cts["inv"], rlk, 5), "exp": nl.he_exp(eng, a, cts["exp"], rlk, 5),
                "sigmoid": nl.he_sigmoid(eng, cts["sigmoid"], rlk),
                "log": nl.he_log(eng, cts["log"], rlk), "sqrt": nl.he_sqrt(eng, cts["sqrt"], rlk, 6)}
        got = {k: eng.dcd(eng.dec(c, sk)) for k, c in outs.items()}
        if logp == 59:
            diffs = {k: np.max(np.abs(got[k] - g[k])) for k in outs}
            assert all(d < 1e-4 for d in diffs.values()), diffs
        else:
            an, bn = 2 - msgs["inv"], 1 - msgs["inv"]
            for _ in range(5):
                bn = bn * bn
                an = an * (bn + 1)
            plain = {"inv": (an, 1e-4), "exp": (np.exp(a * msgs["exp"]), 1e-4),
                     "sigmoid": (1 / (1 + np.exp(-msgs["sigmoid"])), 1e-3),
                     "log": (np.log(1 + msgs["log"]), 1e-2), "sqrt": (np.sqrt(msgs["sqrt"]), 1e-2)}
            diffs = {k: np.max(np.abs(got[k] - want)) for k, (want, _) in plain.items()}
            assert all(diffs[k] < tol for k, (_, tol) in plain.items()), diffs
        assert all(mine[k] > before[k] for k in MODES) and other == before_other


def _reference_cmp(device):
    """he_cmp at logn=15/logq=881/slots=4/Delta=2^30, iter=5, alpha=2
    (tests/test_golden_algo.py::test_golden_algo_cmp): within 1e-4 of the
    binary's decode, the decision bits those of the plaintext comparison."""
    from gpqhe_tpu_torch.algo import nonlinear as nl
    g = _golden("golden_algo_cmp.json")
    ctx = HeContext(logn=15, q=1 << 881, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf(), device=device)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m0 = sample.sample_z01vec(eng.rng, ctx.slots)
    m0 = sample.sample_z01vec(eng.rng, ctx.slots)      # sampled twice, as the binary does
    assert np.array_equal(m0, g["m0"])
    ma, mb = m0.real + 0.5, m0.imag + 0.5
    ct1 = eng.enc_pk(eng.ecd(np.asarray(ma, dtype=np.complex128)), pk)
    ct2 = eng.enc_pk(eng.ecd(np.asarray(mb, dtype=np.complex128)), pk)
    got = eng.dcd(eng.dec(nl.he_cmp(eng, ct1, ct2, rlk, iter=5, alpha=2), sk))
    assert np.max(np.abs(got - g["cmp"])) < 1e-4
    assert np.array_equal(np.round(got.real), (ma > mb).astype(float))


REFERENCE = {"logn11": _reference_logn11, "linear": _reference_linear,
             "nonlinear": _reference_nonlinear, "cmp": _reference_cmp}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REFERENCE))
def test_cuda_matches_the_reference_binary(cuda_device, case):
    """The engine on the card against the reference binary's outputs
    (tests/golden/): each case's gates raise inside it."""
    REFERENCE[case](cuda_device)


@pytest.mark.cuda
def test_cuda_full_width_checks(cuda_device):
    """tests/test_full_params.py on the card at logn=14/logq=438/slots=16/
    Delta=2^50 (torch_cases.full_width_checks): enc_sk, enc_pk, moddown,
    the add and mul variants, a chained product, conj and rot by every r in
    0..15, each within 1e-5; rs(mul) one level down."""
    eng = CKKS(HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50), rng=Surf(),
               device=cuda_device)
    pk, sk = eng.keypair()
    out = full_width_checks(eng, pk, sk, eng.genrlk(sk), eng.genck(sk), eng.genrk(sk))
    assert out["mul_level_ok"] and all(f"rot{r}" in out["diffs"] for r in range(16))
    assert all(d < 1e-5 for d in out["diffs"].values()), out["diffs"]


@pytest.mark.cuda
def test_cuda_bootstrap_at_logn15(cuda_device):
    """tests/test_bootstrap_refscale.py on the card: HeContext(15, 2^881, 4,
    2^30), rlk, ck and the bootstrap's rotation keys, m0 = sample_z01vec *
    0.1 and a second message, each encrypted, taken down to l = 1 and
    bootstrapped (iter derived, 9): back at l >= 10 within 1e-2; every u64
    NTT entry launched over encrypt, bootstrap and decrypt; each of K4-K7
    launched by the bootstraps, and K5 at the shape classes chip_smoke.py
    times on its kernels15 lines (BOOT15_K5); the graphed calls (captures,
    then replays) torch.equal to the same bootstrap under
    graphs.disabled()."""
    from torch_cases import BOOT15_K5, ew_by_kernel, ew_counters
    ctx = HeContext(logn=15, q=1 << 881, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf(), device=cuda_device)
    pk, sk = eng.keypair()
    rlk, ck = eng.genrlk(sk), eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    bctx = bs.BootstrapContext(eng)
    rng = np.random.default_rng(15)
    msgs = [sample.sample_z01vec(eng.rng, ctx.slots) * 0.1,
            0.1 * (rng.random(ctx.slots) + 1j * rng.random(ctx.slots))]
    ntt_before = dict(ntt_cuda.LAUNCHES)
    cts = []
    for m in msgs:
        ct = eng.enc_pk(eng.ecd(m), pk)
        while ct.l > 1:
            ct = eng.moddown(ct)
        cts.append(ct)

    def run(ct):
        return bs.bootstrap(eng, bctx, ct, rlk, ck, rk)
    ew_before = ew_counters()
    got = [run(c) for c in cts]
    torch.cuda.synchronize()
    ew_after = ew_counters()
    assert all(v > 0 for v in ew_by_kernel({k: ew_after[k] - ew_before.get(k, 0)
                                             for k in ew_after}).values())
    for entry, dim, lead, nw in BOOT15_K5:
        key = f"{entry} {list(lead) + [dim, 1 << 15]}" + (f" x{nw}" if nw else "")
        assert ew_after.get(key, 0) > ew_before.get(key, 0), key
    got += [run(c) for c in cts]
    with graphs.disabled():
        want = [run(c) for c in cts]
    for i, r in enumerate(got):
        assert not any(equal_cts(r, want[i % 2]).values()), i
    for r, m in zip(got, msgs):
        assert r.l >= 10 and np.max(np.abs(eng.dcd(eng.dec(r, sk)) - m)) < 1e-2
    torch.cuda.synchronize()
    assert all(ntt_cuda.LAUNCHES[k] > ntt_before[k] for k in MODES)


@pytest.mark.cuda
def test_cuda_keys_saved_and_loaded_onto_the_card(cuda_device, tmp_path):
    """utils/serialize.py: a ciphertext, rlk and a rotation bank through .npz
    files and back onto the card (load's default device): every tensor
    torch.equal, the ledger and the rotations equal, and mul_rs and rot
    from the loaded keys torch.equal to the same from the originals."""
    from gpqhe_tpu_torch.utils import serialize
    ctx = HeContext(logn=11, q=1 << 48, slots=4, Delta=1 << 22)
    eng = CKKS(ctx, rng=Surf(), device=cuda_device)
    pk, sk = eng.keypair()
    objs = {"ct": eng.enc_pk(eng.ecd(sample.sample_z01vec(eng.rng, 4)), pk),
            "rlk": eng.genrlk(sk), "rk": eng.genrk(sk)}
    loaded = {}
    for name, obj in objs.items():
        serialize.save(str(tmp_path / f"{name}.npz"), ctx, obj)
        loaded[name] = serialize.load(str(tmp_path / f"{name}.npz"), ctx)

    def tensors(x):
        if isinstance(x, dict):
            return [t for r in sorted(x) for t in tensors(x[r])]
        return [v for v in vars(x).values() if isinstance(v, torch.Tensor)]
    for name in objs:
        a, b = tensors(objs[name]), tensors(loaded[name])
        assert len(a) == len(b) > 0 and all(y.is_cuda and torch.equal(x, y) for x, y in zip(a, b))
    ct, lct = objs["ct"], loaded["ct"]
    assert (ct.l, ct.nu, ct.B) == (lct.l, lct.nu, lct.B) and sorted(loaded["rk"]) == sorted(objs["rk"])
    r = max(objs["rk"])
    for x, y in ((eng.mul_rs(ct, ct, objs["rlk"]), eng.mul_rs(ct, ct, loaded["rlk"])),
                 (eng.rot(ct, r, objs["rk"]), eng.rot(ct, r, loaded["rk"]))):
        assert torch.equal(x.c0, y.c0) and torch.equal(x.c1, y.c1)


CLI_SMALL = ["--logn=9", "--logq=120", "--slots=4", "--logDelta=30"]
CLI_CASES = {"mul pk": ["mul", "pk"], "exp": ["exp"],
             "mesh virtual": ["mul", "pk", "--mesh=2x2x1:virtual"],
             "mesh of cards": ["mul", "pk", "--mesh=2x2x1"] + CLI_SMALL}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cuda_cli_as_a_user_runs_it(cuda_device, case):
    """python -m gpqhe_tpu_torch at its defaults on the card: mul pk and exp
    exit 0 with an [ok] line and the kernel's launches on their "device"
    line; mul pk on a virtual 2x2x1 mesh of the card says its mesh mode;
    without :virtual the same mesh exits 2, "needs 4 devices", where the
    machine has fewer than 4 GPUs (at a small ring: the answer does not
    depend on it)."""
    import re
    argv = CLI_CASES[case]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-m", "gpqhe_tpu_torch"] + argv, cwd=root,
                       capture_output=True, text=True, timeout=900)
    lines = p.stdout.splitlines()
    oks = [ln for ln in lines if ln.startswith("[ok] ")]
    said = [ln for ln in lines if ln.startswith(("mesh mode: ", "--mesh="))]
    why = f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}"
    if case == "mesh of cards" and torch.cuda.device_count() < 4:
        assert p.returncode == 2 and not oks and said and "needs 4 devices" in said[0], why
        return
    assert p.returncode == 0 and oks and not any(ln.startswith("[FAIL]") for ln in lines), why
    if case.startswith("mesh"):
        assert said[:1] == ["mesh mode: {'limb': 2, 'coeff': 2, 'batch': 1}"], why
    else:
        m = re.search(r"^device (.*): NTT kernel launches (\{.*\})$", p.stdout, re.M)
        counts = json.loads(m.group(2).replace("'", '"')) if m else {}
        assert counts and all(c > 0 for c in counts.values()), why


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

from torch_cases import first_difference, is_graph, mixed_devices      # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_mesh_of_card_and_host_matches_single_device(cuda_device, logp):
    """(2,2,2) with position (l, c, b) on the card when l + c is even, else on
    the host: every limb psum and coefficient swap, and half of each scatter
    and gather, is a copy between the two (the card's blocks through the
    kernel, the host's through the twin), and no program is graphed.
    Bit-equal to CKKS on the card."""
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
    # two devices: the programs run eagerly, and the mesh says why
    assert not mesh.graphable and mesh.eager_why and meng._mesh_jit
    assert not any(is_graph(f) for f in meng._mesh_jit.values())


@pytest.mark.cuda
def test_cuda_two_process_mesh_over_gloo(cuda_device):
    """gpqhe_tpu_torch.parallel.mp_mul_rs with both ranks on the card over
    gloo (every message staged through host memory), both layouts and both
    chains: each rank's ops equal to the single-device engine's, its
    chain's kernel launched and the other's not, bytes across the processes
    and staged, and no program graphed (a graph does not capture the
    messages)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-m", "gpqhe_tpu_torch.parallel.mp_mul_rs",
                        "--device=cuda", "--backend=gloo", "--logn=9", "--logq=120",
                        "--logp=59,29", "--mesh=2x2x2,1x4x2", "--timeout=300"],
                       cwd=root, capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}"
    assert p.stdout.splitlines()[-1].startswith("mp_mul_rs: PASS")
    lines = [json.loads(t) for t in p.stdout.splitlines() if t.startswith("{")]
    assert len(lines) == 8 and {ln["logp"] for ln in lines} == {59, 29}
    for ln in lines:
        mine, other = ("u64", "u32") if ln["logp"] == 59 else ("u32", "u64")
        assert all(ln["equal"].values()) and ln["device"] == "cuda:0"
        assert ln["launches"][mine]["fwd"] > 0 and ln["launches"][mine]["inv"] > 0
        assert not any(ln["launches"][other].values())
        assert ln["graphed"] is False
        kinds = [k for t in ln["traffic"].values() for k in t.values()]
        assert sum(k["process"][1] for k in kinds) > 0 and sum(k["staged"][1] for k in kinds) > 0


# -- the rest of the JAX suite on the card: the logp=9 chain, the exact oracle,
# -- full packing (torch_cases.py's cases, which the CPU tests hold to JAX) ---

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
    31/47/48; batch 8) on edge words; the digit product's sums as values
    mod 2^(16 kd), its f64 estimate within a relative 2^-45 (summed in
    another order)."""
    from torch_cases import ew_compare, ew_counters, elementwise_cases
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
    from torch_cases import elementwise_edge_cases
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
    """K7, the CRT lift, decompose and the digit product at the edges of their
    designs (torch_cases.py's elementwise_edge_cases): K = 1 .. 3071 limbs
    around whole chunks of 32, rows not a multiple of a block's, constant,
    broadcast (two leading rows), row-strided and limb-strided operands
    through cuda_build.strides3, bool and int64 row bits, the lift at one,
    two and four chunks; decompose around its tiles of primes and staged
    chunks of limbs, at every src_bits edge, on the three widths of prime;
    the digit product around its blocks of coefficients and byte columns
    and its chunks of depth, on strided, broadcast and misaligned residues;
    each launch torch.equal to the plain version on the same CUDA tensors
    (the digit sums as values mod 2^(16 kd), the f64 estimate within a
    relative 2^-45: torch_cases.ew_compare)."""
    from torch_cases import ew_compare, ew_counters
    cases = [c for c in _edge_cases(cuda_device) if c["entry"] == entry]
    before = ew_counters()[entry]
    for case in cases:
        got, want = case["kern"](), case["plain"]()
        torch.cuda.synchronize()
        assert ew_compare(got, want)[0], case["shape"]
    assert ew_counters()[entry] > before


def _decomposes_counted(fn, k: int, rows: int, dim: int):
    """fn() (one decompose_core of rows rows of k limbs into dim primes) and
    the DECOMP counter's change: one call, on the tensor cores where
    rns_cuda.takes_mma(k)."""
    from gpqhe_tpu_torch.ops import rns, rns_cuda
    before = dict(rns.DECOMP)
    out = fn()
    got = {key: rns.DECOMP[key] - before[key] for key in before}
    assert got == {"calls": 1, "tc_calls": int(rns_cuda.takes_mma(k)), "rows": rows,
                   "limb_words": rows * k, "residue_words": rows * dim}, got
    return out


@pytest.mark.cuda
def test_cuda_decompose_routes_at_tile_edges(cuda_device):
    """decompose's edge cases (torch_cases.py's DECOMPOSE_EDGES and K* - 1,
    K*: tiles of primes and of byte columns, chunks of limbs and of depth,
    every src_bits edge, the three widths of prime, strided, broadcast and
    leading-axis operands, a mesh shard's primes) through both routes,
    rns_cuda.decompose_imad and decompose_mma, each torch.equal to the plain
    version; the dispatcher takes the route K gives it, counted in DECOMP."""
    from gpqhe_tpu_torch.ops import rns, rns_cuda
    cases = [c for c in _edge_cases(cuda_device) if c["entry"] == "decompose"]
    ks = {c["args"][0].shape[-1] for c in cases}
    assert {rns_cuda.MMA_MIN_LIMBS - 1, rns_cuda.MMA_MIN_LIMBS} <= ks and max(ks) >= 130
    for case in cases:
        a, ps, pinv, w, src = case["args"]
        want = case["plain"]()
        for fn in (rns_cuda.decompose_imad, rns_cuda.decompose_mma):
            got = fn(*case["args"])
            torch.cuda.synchronize()
            assert torch.equal(got, want), (case["shape"], fn.__name__)
        k = a.shape[-1]
        got = _decomposes_counted(lambda: rns.decompose_core(*case["args"]), k,
                                  a.numel() // k, ps.numel())
        assert torch.equal(got, want), case["shape"]


# decompose at the cells' shapes and around K*: (logn, K, primes, src_bits,
# layout): n14's product and key switch (14 limbs into 16 and 24 primes),
# n15's (28 into 31 and 47), n16's (55 into 60 and, signed, 90), K* - 1 and
# K* at logn=15; "strided" rows 3 words longer than K, "ragged" n - 5 rows
DECOMPOSE_CELLS = ((14, 14, 16, None, "plain"), (14, 14, 24, 32 * 14, "strided"),
                   (15, 28, 31, None, "plain"), (15, 28, 47, 32 * 28, "ragged"),
                   (16, 55, 60, None, "plain"), (16, 55, 90, 32 * 55, "plain"),
                   (16, 55, 60, 32 * 55 - 5, "ragged"), (15, "K*-1", 31, None, "strided"),
                   (15, "K*", 31, 32, "ragged"), (15, "K*", 47, None, "plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("logn,k,dim,src,layout", DECOMPOSE_CELLS,
                         ids=[f"{a}-{b}-{c}-{d}-{e}" for a, b, c, d, e in DECOMPOSE_CELLS])
def test_cuda_decompose_routes_at_the_cells_shapes(cuda_device, logn, k, dim, src, layout):
    """Both routes of decompose at the cells' shapes and at K* - 1 and K*,
    on random limbs with all-ones and zero rows among them, torch.equal to
    plain_decompose_core or plain_decompose_signed; the dispatcher
    (rns.decompose_core) takes the tensor cores exactly where K >= K*,
    counted in DECOMP["tc_calls"]."""
    from gpqhe_tpu_torch.ops import rns, rns_cuda
    from torch_cases import ew_limbs
    k = {"K*-1": rns_cuda.MMA_MIN_LIMBS - 1, "K*": rns_cuda.MMA_MIN_LIMBS}.get(k, k)
    rng = np.random.default_rng(logn * 100 + k)
    ring = RingEngine(PolyContext(logn, q=1 << 20, dim_cap=dim), device=cuda_device)
    n = 1 << logn
    a = ew_limbs(rng, (n, k + 3), cuda_device)
    a[0], a[1] = 0xFFFFFFFF, 0
    a = a[:, :k] if layout == "strided" else a[:n - 5, :k] if layout == "ragged" else \
        a[:, :k].contiguous()
    ba, w = ring.ba(dim), ring.weights(dim, k)
    want = (rns.plain_decompose_core(a, ba.ps, ba.pinv, w) if src is None
            else rns.plain_decompose_signed(a, ba.ps, ba.pinv, w, src))
    for fn in (rns_cuda.decompose_imad, rns_cuda.decompose_mma):
        got = fn(a, ba.ps, ba.pinv, w, src)
        torch.cuda.synchronize()
        assert torch.equal(got, want), fn.__name__
    got = _decomposes_counted(lambda: rns.decompose(a, ba, w, src), k, a.shape[0], dim)
    assert torch.equal(got, want)
    assert rns_cuda.takes_mma(k) == (k >= rns_cuda.MMA_MIN_LIMBS)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["modmath_mulmod", "modmath_mont_mul", "modmath_addmod",
                                   "modmath_submod", "modmath_to_mont"])
def test_cuda_modmath_at_the_edges_of_its_design(cuda_device, entry):
    """K5's elementwise kernel at the edges of its design (torch_cases.py's
    MODMATH_EDGES): rows and n that are not a multiple of a thread's 4 words
    or a block's 1024, views one word off 16-byte alignment, stride-0
    operands on each axis, the key bank's row and column slices, A past
    65535, the three widths of prime, mont_mul on any u64 words; each
    launch torch.equal to the plain version on the same CUDA tensors."""
    from torch_cases import ew_compare, ew_counters
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
@pytest.mark.parametrize("n,k,stride", [(1 << 15, 28, 1 << 14), (1 << 15, 28, 1 << 12),
                                        (1 << 14, 14, 1 << 13), (1 << 14, 14, 1 << 9),
                                        (1 << 10, 5, 1 << 6), (1 << 16, 55, 1 << 13)])
def test_cuda_fill_rows_equals_plain_in_one_launch(cuda_device, n, k, stride):
    """csrc/limbs.cu's fill torch.equal to plain_fill_rows at the bootstrap
    ring's [2^15, 28] and the linear ring's [2^14, 14], with const_pt's
    stride n/2 and ecd's gap (slots 4 and 16), at an odd K (a word a
    thread), and at logn=16's [2^16, 55] with ecd's 8 rows (440 of the
    launch's 512 words), in one launch."""
    from gpqhe_tpu_torch.ops import limbs, limbs_cuda
    rows = np.random.default_rng(n + stride).integers(
        0, 1 << 32, size=(n // stride, k), dtype=np.uint64).astype(np.uint32)
    rows[0] = 0xFFFFFFFF
    want = limbs.plain_fill_rows(rows, n, stride, cuda_device)
    torch.cuda.synchronize()
    before = limbs_cuda.LAUNCHES["fill_rows"]
    got = limbs.fill_rows(rows, n, stride, cuda_device)
    assert limbs_cuda.LAUNCHES["fill_rows"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["fills", "bootstrap15"])
def test_cuda_profile_shows_the_fills_and_one_copy(cuda_device, what):
    """tests/torch_profile_copies.py in a fresh process (its capture the
    first of the process: a later one now and then misses a pageable copy):
    the five fills are five launches and no Memcpy HtoD; a logn=15
    bootstrap (the benchmark's n15.bootstrap request) makes one Memcpy HtoD,
    raise_modulus's modulus limbs, and 19 fill launches for its 15 const_pt
    and 4 ecd, and comes back at l >= 10 within 1e-2 of the message."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, os.path.join(root, "tests", "torch_profile_copies.py"),
                        what], cwd=root, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}"
    got = json.loads(p.stdout.splitlines()[-1])
    if what == "fills":
        assert got == {"fill_kernels": 5, "memcpy_htod": 0, "equal": True}
    else:
        assert {k: got[k] for k in ("fill_launches", "encode", "counted_copies",
                                    "fill_kernels", "memcpy_htod")} == {
            "fill_launches": 19, "encode": {"on_card": 19, "host": 0}, "counted_copies": 1,
            "fill_kernels": 19, "memcpy_htod": 1}
        assert got["level"] >= 10 and got["decode_diff"] < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_keyswitch_path_launches_the_elementwise_kernels(cuda_device, logp):
    """The key-switch path on the card goes through K4-K7 (each kernel's
    launch count grows) and none of them on the host engine."""
    from torch_cases import ew_by_kernel, ew_counters
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

from torch_cases import (NTT4_PATH, ntt4_compare, ntt4_edge_cases, ntt4_input,  # noqa: E402
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
    the matmul engine launches K8 and no butterfly NTT.  So are rot, conj,
    mulpt, a batch of two products and the classic gemv's, each within 1e-5
    of its plaintext result on both; the matmul engine's gemv_hoisted falls
    back to the classic gemv (one fallback, warned), the butterfly
    engine's does not."""
    import warnings
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
        ck, rk = eng.genck(sk), eng.genrk(sk)
        A = sample.sample_z01vec(eng.rng, ctx.slots * ctx.slots)
        plan = linalg.HoistedGemvPlan(eng, A)
        more = {"rot": (eng.rot(ct1, 1, rk), np.roll(m1, -1)), "conj": (eng.conj(ct1, ck), np.conj(m1)),
                "mulpt": (eng.rs(eng.mulpt(ct1, eng.ecd(m2))), m1 * m2),
                "batch": (eng.mul_rs_batch([ct1, ct2], [ct2, ct1], rlk)[1], m2 * m1),
                "gemv": (linalg.gemv(eng, None, ct1, rk, plan=plan), A.reshape(16, 16) @ m1)}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            hoisted = linalg.gemv_hoisted(eng, plan, ct1, rk)
        for name, (c, want) in more.items():
            assert np.max(np.abs(eng.dcd(eng.dec(c, sk)) - want)) < 1e-5, (impl, name)
        out[impl] += ({k: c for k, (c, _) in more.items()}, hoisted, plan.fallbacks,
                      sum("falling back" in str(w.message) for w in caught))
    (cb, kb, nb, db, mb, hb, fb, _), (cm, km, nm, dm, mm, hm, fm, wm) = (out["butterfly"],
                                                                        out["matmul"])
    assert torch.equal(cb.c0, cm.c0) and torch.equal(cb.c1, cm.c1)
    assert (cb.l, cb.nu, cb.B) == (cm.l, cm.nu, cm.B)
    assert not torch.equal(kb.p0hat, km.p0hat)
    assert db < 1e-5 and dm < 1e-5
    assert nb[2] == 0 and nb[0] + nb[1] == 4          # four transforms, one launch each
    assert nm[0] == nm[1] == 0 and nm[2] == 8          # two stages each
    for name in mb:
        assert not any(equal_cts(mm[name], mb[name]).values()), name
    assert not any(equal_cts(hm, mb["gemv"]).values())
    assert (fb, fm) == (0, 1) and wm >= 1


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
    equal to an eager call's (torch_cases.graph_check)."""
    case = _graph_case(cuda_device, logp, impl)
    r = graph_check(case["ops"][op], case["inputs"], f"{op} logp={logp} {impl}")
    g = case["eng"].ring.graphs
    assert r["launches"] > 0 and g.captures > 0 and g.replays > 0


@pytest.mark.cuda
def test_cuda_mul_rs_replays_one_graph(cuda_device):
    """After its first call a mul_rs is one replay of its level's graph:
    no capture, one replay, one graph under the program's key; the host
    dispatches that graph and at most 8 copies and kernels."""
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
    # the host's dispatches of a replay, read as the benchmark reads them:
    # one graph launch, and at most 8 copies and kernels beside it (the
    # static inputs' copies, the outputs' clones)
    from torch.profiler import ProfilerActivity, profile

    from gpubench.devtrace import host_dispatches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.mul_rs(x["ct1"], x["ct2"], rlk)
        torch.cuda.synchronize()
    host = host_dispatches([e.name for e in prof.events()])
    assert host["graph_launches"] == 1 and host["copies"] + host["kernel_launches"] <= 8, host


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

from torch_cases import (MESH_HEADS, graph_same, mesh_graphed,  # noqa: E402
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
    at replays (torch_cases.graph_check) and to the single-device engine on
    every input set; three replays count the launches and the mesh traffic
    of three eager calls; an eager call launches the local transforms the
    layout implies on its chain's kernel and none on the other."""
    c = _mesh_case(cuda_device, logp)
    fn = c["sharded"][op]
    r = graph_check(fn, c["inputs"], f"mesh {op} logp={logp}")
    assert r["launches"] > 0
    for x in c["inputs"]:
        assert graph_same(fn(x), c["single"][op](x))
    assert c["mesh"].graphable and mesh_graphed(c["meng"], op, c["inputs"][0]["ct"].l)
    gains = mesh_replays_match(fn, c["inputs"], c["mesh"], f"{op} logp={logp}")
    assert gains["traffic"]["psum"][0] > 0 and gains["traffic"]["ppermute"][0] > 0
    # the local transforms of one call: a position's mul_rs 2 forward (the
    # four polys in one launch, then d2) and 2 inverse (the cross terms, the
    # key switch's halves); rot and conj 1 + 1; the gemv step 2 inverse a
    # position and its prologue's 2 forward on the first device
    P = len(c["mesh"].positions)
    want = {"mul_rs": (2 * P, 2 * P), "rot": (P, P), "conj": (P, P), "gemv_full": (2, 2 * P)}[op]
    mine, other = _chain_launches(logp)
    before, before_other = dict(mine), dict(other)
    with graphs.disabled():
        fn(c["inputs"][0])
    torch.cuda.synchronize()
    assert tuple(mine[k] - before[k] for k in MODES) == want + (0,) and other == before_other


@pytest.mark.cuda
@pytest.mark.parametrize("logp", [59, 29])
def test_cuda_sharded_poly_mul_3d_graphed(cuda_device, logp):
    """build_sharded_poly_mul_3d on a virtual (2,2,2) mesh of the card, in
    the mesh's own graphs: its capture and a replay torch.equal to eager
    and to RingEngine.poly_mul on the card, pair by pair; eagerly it
    launches its chain's kernel and not the other."""
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
    mine, other = _chain_launches(logp)
    before, before_other = dict(mine), dict(other)
    with graphs.disabled():
        want = [f(a, b) for a, b in sets]
    torch.cuda.synchronize()
    assert mine["fwd"] > before["fwd"] and mine["inv"] > before["inv"] and other == before_other
    assert isinstance(f, graphs.Program) and len(f.graphs) == 1 and mesh.graphs.replays == 1
    for (a, b), g, e in zip(sets, got, want):
        assert torch.equal(g, e)
        for i in range(2):
            assert torch.equal(g[i], ring.poly_mul(a[i], b[i], 8, 128, 4))


@pytest.mark.cuda
def test_cuda_mesh_coeff2slot_graphed(cuda_device):
    """bootstrap.coeff2slot (SubSum rotations, a conjugation, four hoisted
    gemvs, mulpt and rescales) on a virtual (2,4,1) mesh of the card at
    logn=6/logq=400/slots=4/Delta=2^30, hoist_bits=160 (tests/
    test_torch_mesh_compose.py's ring), on the single-device engine's keys:
    every sharded program a CUDA graph, the graphed calls (captures, then
    replays) and an eager one torch.equal to the single-device engine's,
    the eager call moving the same traffic as a graphed one."""
    ctx = HeContext(logn=6, q=1 << 400, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf(), device=cuda_device, hoist_bits=160)
    pk, sk = eng.keypair()
    ck, rk = eng.genck(sk), eng.genrk(sk, bs.bootstrap_rotations(ctx))
    ct = eng.enc_pk(eng.ecd(sample.sample_z01vec(eng.rng, ctx.slots) / (1 << 30)), pk)
    want = bs.coeff2slot(eng, bs.BootstrapContext(eng), ct, ck, rk)
    mesh = _virtual(cuda_device, 2, 4)
    meng = MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=160)
    bctx = bs.BootstrapContext(meng)
    got = [bs.coeff2slot(meng, bctx, ct, ck, rk) for _ in range(2)]
    traffic = []
    for mode in ("graphed", "eager"):
        mesh.reset_traffic()
        with graphs.disabled() if mode == "eager" else contextlib.nullcontext():
            got.append(bs.coeff2slot(meng, bctx, ct, ck, rk))
        traffic.append({k: list(v) for k, v in mesh.traffic.items()})
    progs = list(meng._mesh_jit.values())
    assert progs and mesh.graphable and all(is_graph(f) for f in progs)
    assert traffic[0] == traffic[1] and traffic[0]["psum"][0] > 0
    for pair in got:
        for a, b in zip(pair, want):
            assert not any(equal_cts(a, b).values())
