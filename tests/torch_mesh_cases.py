"""Shared by test_torch_mesh_engine.py (59-bit chain) and
test_torch_mesh_engine29.py (logp=29): the sharded programs of the port's
parallel/mesh.py on a virtual (limb=2, coeff=2, batch=2) CPU mesh against
the JAX package's programs on its 8 virtual devices and against the port's
single-device engine, at logn=6/logq=110/slots=4/Delta=2^30
(tests/test_parallel.py:72-111, 171-253).

The JAX engine makes the keys and ciphertexts from Surf(); they cross to the
port as numpy arrays (scheme/types.py::from_numpy), so both sides compute on
the same words.  Tolerance: none (np.array_equal), plus the 1e-5 decode
checks of the JAX tests.
"""

import numpy as np
import jax.numpy as jnp

import gpqhe_tpu
from gpqhe_tpu.algo.linalg import HoistedGemvPlan as JHoistedGemvPlan
from gpqhe_tpu.parallel import mesh as jmesh
from gpqhe_tpu.ring import sample as jsmp
from gpqhe_tpu.substrate.surf import Surf as JSurf

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.ops.modmath import u64_to_torch
from gpqhe_tpu_torch.parallel import mesh as tmesh
from gpqhe_tpu_torch.scheme.types import Ciphertext, from_numpy, limbs_to_numpy
from gpqhe_tpu_torch.substrate.surf import Surf

RING = dict(logn=6, q=1 << 110, slots=4, Delta=1 << 30)
B = 2                                      # the mesh's batch axis


def cross(obj, kind):
    """A JAX-package key or ciphertext as the port's, on the CPU."""
    if kind == "swk":
        arrays = {"p0hat": np.asarray(obj.p0hat), "p1hat": np.asarray(obj.p1hat)}
    elif kind == "ct":
        arrays = {"c0": np.asarray(obj.c0), "c1": np.asarray(obj.c1),
                  "meta": [obj.l, obj.nu, obj.B]}
    else:
        arrays = {"s": np.asarray(obj.s)}
    return from_numpy(kind, arrays, "cpu")


def bat(x):
    return x[None].expand((B,) + tuple(x.shape))


def jbat(x):
    return jnp.broadcast_to(x[None], (B,) + x.shape)


class MeshCase:
    """Both packages' engines on one chain, the JAX one with keys."""

    def __init__(self, logp: int, ring: dict = RING):
        self.jctx = gpqhe_tpu.HeContext(**ring, logp=logp)
        self.ctx = gt.HeContext(**ring, logp=logp)
        # extra hoist margin so the limb-padded dims_h still fits the swk limbs
        self.jeng = je = gpqhe_tpu.CKKS(self.jctx, rng=JSurf(), hoist_bits=160)
        self.eng = gt.CKKS(self.ctx, rng=Surf(), device="cpu", hoist_bits=160)
        pk, self.jsk = je.keypair()
        self.jrlk = je.genrlk(self.jsk)
        self.jck = je.genck(self.jsk)
        self.jrk = je.genrk(self.jsk)
        self.m0 = jsmp.sample_z01vec(je.rng, self.jctx.slots)
        self.m1 = jsmp.sample_z01vec(je.rng, self.jctx.slots)
        self.jct1 = je.enc_pk(je.ecd(self.m0), pk)
        self.jct2 = je.enc_pk(je.ecd(self.m1), pk)
        self.sk = cross(self.jsk, "sk")
        self.ct1, self.ct2 = cross(self.jct1, "ct"), cross(self.jct2, "ct")
        self.jmesh = jmesh.make_he_mesh3(8, limb=2, coeff=2)
        self.mesh = tmesh.make_he_mesh3(8, limb=2, coeff=2, devices=["cpu"] * 8)

    def decode(self, ref, c0, c1):
        out = Ciphertext(l=ref.l, nu=ref.nu, B=ref.B, c0=c0, c1=c1)
        return self.eng.dcd(self.eng.dec(out, self.sk))

    def check_pair(self, got, want_jax, ref):
        """got: the port's sharded (c0, c1) batches; want_jax: JAX's; ref:
        the port's single-device ciphertext."""
        for g, w, r in zip(got, want_jax, (ref.c0, ref.c1)):
            assert g.shape[0] == B and np.array_equal(limbs_to_numpy(g), np.asarray(w))
            for i in range(B):
                assert np.array_equal(limbs_to_numpy(g[i]), limbs_to_numpy(r)), i

    def mul_rs(self):
        l = self.ctx.L
        rlk = cross(self.jrlk, "swk")
        jf = jmesh.build_sharded_mul_rs(self.jeng, l, self.jmesh)
        want = jf(jbat(self.jct1.c0), jbat(self.jct1.c1), jbat(self.jct2.c0),
                  jbat(self.jct2.c1), self.jrlk.p0hat, self.jrlk.p1hat)
        tf = tmesh.build_sharded_mul_rs(self.eng, l, self.mesh)
        got = tf(bat(self.ct1.c0), bat(self.ct1.c1), bat(self.ct2.c0), bat(self.ct2.c1),
                 rlk.p0hat, rlk.p1hat)
        ref = self.eng.mul_rs(self.ct1, self.ct2, rlk)
        self.check_pair(got, want, ref)
        assert np.max(np.abs(self.decode(ref, got[0][0], got[1][0]) - self.m0 * self.m1)) < 1e-5

    def rot(self, r):
        """r = 1: rotation by one slot; r = None: conjugation."""
        jswk = self.jck if r is None else self.jrk[1]
        swk = cross(jswk, "swk")
        jf = jmesh.build_sharded_rot(self.jeng, self.jct1.l, self.jmesh, r)
        want = jf(jbat(self.jct1.c0), jbat(self.jct1.c1), jswk.p0hat, jswk.p1hat)
        tf = tmesh.build_sharded_rot(self.eng, self.ct1.l, self.mesh, r)
        got = tf(bat(self.ct1.c0), bat(self.ct1.c1), swk.p0hat, swk.p1hat)
        ref = (self.eng.conj(self.ct1, swk) if r is None
               else self.eng.rot(self.ct1, 1, {1: swk}))
        self.check_pair(got, want, ref)
        expect = np.conj(self.m0) if r is None else np.roll(self.m0, -1)
        assert np.max(np.abs(self.decode(ref, got[0][0], got[1][0]) - expect)) < 1e-5

    def gemv_step(self):
        """One double-hoisted giant step: the JAX engine's prologue makes the
        operands, which cross as u64 words."""
        je, jct = self.jeng, self.jct1
        rng = np.random.default_rng(3)
        n = self.jctx.slots * self.jctx.slots
        A = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        plan = JHoistedGemvPlan(je, A)
        l = jct.l
        dims_h, dimc, _ = plan.dims(je, l)
        # pad both bases up to the limb-axis multiple (still valid CRT ranges)
        dims_h += dims_h % 2
        dimc += dimc % 2
        bnd_sum = plan.bound_max() * plan.n1
        c1p, c0p = je.hoisted_gemv_prep_fn(l, plan.n1, dims_h, dimc)(jct.c0, jct.c1)
        rk0, rk1 = plan.rk_stack(self.jrk)
        ptx, ptb = plan.pack_slab(je, l, 0, dims=(dims_h, dimc))
        jargs = (c1p, c0p, ptx, ptb, rk0, rk1)
        want = jmesh.build_sharded_gemv_step(je, l, plan.n1, dims_h, dimc, self.jmesh)(*jargs)
        targs = [u64_to_torch(np.asarray(x)) for x in jargs]
        got = tmesh.build_sharded_gemv_step(self.eng, l, plan.n1, dims_h, dimc, self.mesh)(*targs)
        ref = self.eng.hoisted_gemv_step_fn(
            l, dims_h, dimc, bits_h=self.eng.bits_hoist(l, bnd_sum),
            bits_c=self.ctx.bits_mulpt(l, bnd_sum))(*targs)
        for g, w, r in zip(got, want, ref):
            assert np.array_equal(limbs_to_numpy(g), np.asarray(w))
            assert np.array_equal(limbs_to_numpy(g), limbs_to_numpy(r))
