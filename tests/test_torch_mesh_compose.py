"""Whole compositions on the port's MeshCKKS (parallel/engine.py), against
the JAX package's MeshCKKS and the port's single-device engine.

coeff2slot — SubSum rotations, a conjugation, four hoisted gemvs (sharded
giant steps and outer rotations), mulpt and rescales — runs on a virtual
(limb=2, coeff=4, batch=1) CPU mesh at logn=6/logq=400/slots=4/Delta=2^30
with hoist_bits=160 (tests/test_parallel.py:322-357).  Every engine draws
its keys and message from its own Surf(), which yields the same stream in
both packages.  Tolerance: none (np.array_equal on c0 and c1 of both output
ciphertexts).  Under `slow`, as the JAX package marks them: the full
bootstrap at logn=5/logq=790/iter=7 and build_sharded_mul_rs at
logn=12/logq=109 with real ladder dims.
"""

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu import bootstrap as jbs
from gpqhe_tpu.parallel import mesh as jmesh
from gpqhe_tpu.parallel.engine import MeshCKKS as JMeshCKKS
from gpqhe_tpu.ring import sample as jsmp
from gpqhe_tpu.substrate.surf import Surf as JSurf

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch import bootstrap as tbs
from gpqhe_tpu_torch.parallel import mesh as tmesh
from gpqhe_tpu_torch.parallel.engine import MeshCKKS
from gpqhe_tpu_torch.ring import sample as tsmp
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
from gpqhe_tpu_torch.substrate.surf import Surf
from gpqhe_tpu_torch.utils import trace

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _words(x):
    return limbs_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    return (np.array_equal(_words(a.c0), _words(b.c0))
            and np.array_equal(_words(a.c1), _words(b.c1)) and a.l == b.l)


def _coeff2slot(eng, bs, smp):
    ctx = eng.ctx
    pk, sk = eng.keypair()
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m0 = smp.sample_z01vec(eng.rng, ctx.slots) / (1 << 30)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    return bs.coeff2slot(eng, bs.BootstrapContext(eng), ct, ck, rk)


def test_mesh_engine_coeff2slot_matches_jax_and_single():
    ring = dict(logn=6, q=1 << 400, slots=4, Delta=1 << 30)
    ctx = gt.HeContext(**ring)
    with trace.op_trace() as single_trace:
        s0, s1 = _coeff2slot(gt.CKKS(ctx, rng=Surf(), device="cpu", hoist_bits=160), tbs, tsmp)
    mesh = tmesh.make_he_mesh3(8, limb=2, coeff=4, devices=CPU8)       # batch=1: one ciphertext
    eng = MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=160)
    assert eng.device == torch.device("cpu")
    with trace.op_trace() as mesh_trace:
        m0, m1 = _coeff2slot(eng, tbs, tsmp)
    assert eng._mesh_jit, "mesh engine never built a sharded program"
    kinds = {key[0] for key in eng._mesh_jit}
    assert kinds == {"rot", "gemvstep"}
    assert _same(s0, m0) and _same(s1, m1)
    # the op trace names the mesh programs as the single-device engine's
    assert mesh_trace.counts == single_trace.counts
    t = mesh.traffic
    assert min(t["psum"][0], t["ppermute"][0], t["scatter"][0], t["gather"][0]) > 0

    jeng = JMeshCKKS(gpqhe_tpu.HeContext(**ring), jmesh.make_he_mesh3(8, limb=2, coeff=4),
                     rng=JSurf(), hoist_bits=160)
    j0, j1 = _coeff2slot(jeng, jbs, jsmp)
    assert jeng._mesh_jit and _same(j0, m0) and _same(j1, m1)


def test_mesh_engine_refuses_a_device_off_the_mesh():
    ctx = gt.HeContext(logn=5, q=1 << 100, slots=2, Delta=1 << 30)
    mesh = tmesh.make_he_mesh3(4, limb=2, coeff=2, devices=CPU8[:4])
    assert MeshCKKS(ctx, mesh, rng=Surf(), device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="contradicts the mesh"):
        MeshCKKS(ctx, mesh, rng=Surf(), device="cuda:0")


def test_mesh_engine_pads_gemv_bases_to_the_limb_axis():
    ctx = gt.HeContext(logn=6, q=1 << 110, slots=4, Delta=1 << 30)
    single = gt.CKKS(ctx, rng=Surf(), device="cpu", hoist_bits=160)
    mesh = tmesh.make_he_mesh3(4, limb=4, coeff=1, devices=CPU8[:4])
    eng = MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=160)
    for bnd in (1.0, 2.0 ** 30, 2.0 ** 45):
        dh, dc = single.gemv_dims(ctx.L, bnd)
        ph, pc = eng.gemv_dims(ctx.L, bnd)
        assert ph % 4 == 0 and pc % 4 == 0 and 0 <= ph - dh < 4 and 0 <= pc - dc < 4
    assert tmesh._batch(mesh, torch.zeros(64, 4)).shape == (1, 64, 4)


@pytest.mark.slow   # two full bootstrap compositions in each package
def test_mesh_engine_full_bootstrap_matches_jax_and_single():
    """tests/test_parallel.py:360-399: raise -> SubSum -> coeff2slot ->
    EvalSin -> slot2coeff -> rs on the mesh engine, dozens of rot / conj /
    gemv-step programs, at the tiny-ring deep ladder (h=16 -> iter=7)."""
    ring = dict(logn=5, q=1 << 790, slots=4, Delta=1 << 30)

    def run(eng, bs, smp):
        ctx = eng.ctx
        pk, sk = eng.keypair()
        rlk = eng.genrlk(sk)
        ck = eng.genck(sk)
        rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
        m0 = smp.sample_z01vec(eng.rng, ctx.slots) * 0.1
        ct = eng.enc_pk(eng.ecd(m0), pk)
        while ct.l > 1:
            ct = eng.moddown(ct)
        out = bs.bootstrap(eng, bs.BootstrapContext(eng), ct, rlk, ck, rk, iter=7)
        return out, m0, sk
    ctx = gt.HeContext(**ring)
    single = gt.CKKS(ctx, rng=Surf(), device="cpu")
    out_s, m0, sk = run(single, tbs, tsmp)
    eng = MeshCKKS(ctx, tmesh.make_he_mesh3(8, limb=2, coeff=4, devices=CPU8), rng=Surf())
    out_m, _, _ = run(eng, tbs, tsmp)
    assert {key[0] for key in eng._mesh_jit} >= {"rot", "gemvstep"}
    assert _same(out_s, out_m)
    assert np.max(np.abs(single.dcd(single.dec(out_m, sk)) - m0)) < 1e-2
    jeng = JMeshCKKS(gpqhe_tpu.HeContext(**ring), jmesh.make_he_mesh3(8, limb=2, coeff=4),
                     rng=JSurf())
    out_j, _, _ = run(jeng, jbs, jsmp)
    assert _same(out_j, out_m)


@pytest.mark.slow   # real ladder dims at logn=12 (security-table logq=109)
def test_sharded_mul_rs_matches_jax_and_engine_logn12():
    from torch_mesh_cases import RING, MeshCase
    MeshCase(59, dict(RING, logn=12, q=1 << 109)).mul_rs()
