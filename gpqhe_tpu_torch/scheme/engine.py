"""CKKS scheme engine on torch: encode/encrypt/keygen/add/mult/rescale.

Port of gpqhe_tpu/scheme/engine.py:
  encode/decode      ref: src/he-encode.c:53-125
  enc/dec            ref: src/he-encrypt.c:37-123
  keygen + swk       ref: src/he-kem.c:43-169
  add family         ref: src/he-add.c:32-142
  mult + relin       ref: src/he-mult.c:40-196
  rescale/moddown    ref: src/he-rescale.c:33-70
  conj/rot           ref: src/he-automorphism.c:40-115
and the double-hoisted gemv programs (Halevi-Shoup hoisting).

Ciphertext polys are limb tensors on the engine's device; each scheme op is
a program of torch calls and CUDA kernel launches, cached under the JAX
engine's key for its jitted program, and on a CUDA device captured as one
CUDA graph per argument shape at first use and replayed after
(utils/graphs.py, the counterpart of jax.jit).  The
divide-round by P in key switching runs without big-int division: r = c mod
P via a small CRT over the first hectx.dim primes, then
u = (c - r) * P^-1 mod 2^(32K) — exact, and identical to mpi_rdiv semantics
(ref: src/types.c:115-128).

Randomness is the shared host surf stream, so keys, errors and messages are
bit-identical to the JAX package's from the same Surf().
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import params
from ..context import HeContext
from ..ops import limbs as lb
from ..ops import limbs_cuda
from ..ops import rns as rns_ops
from ..ops.modmath import cross_terms, key_products, mulmod_sum, u64_to_torch
from ..ops.ntt import ntt_galois_perm
from ..ring import sample
from ..ring.canemb import canemb, invcanemb
from ..ring.poly import RingEngine
from ..substrate import bigint
from ..substrate.surf import Surf, default_rng
from ..utils import trace
from .types import (Ciphertext, Plaintext, PublicKey, SecretKey, SwitchKey,
                    limbs_to_numpy, limbs_to_torch)


class CKKS:
    """Scheme engine bound to one HeContext and one torch device.
    device=None means the GPU ("cuda") and raises where there is none.
    ntt_impl selects the ring's NTT backend (RingEngine): "matmul" is the
    four-step NTT, whose order has no hoisting permutation, so the hoisted
    gemv falls back to the classic path (algo/linalg.py)."""

    def __init__(self, ctx: HeContext, rng: Surf | None = None, device=None,
                 hoist_bits: int | None = None, ntt_impl: str = "butterfly"):
        self.ctx = ctx
        self.ring = RingEngine(ctx.poly, device=device, ntt_impl=ntt_impl)
        self.device = self.ring.device
        self.rng = rng if rng is not None else default_rng()
        self._fns: dict = {}
        # engine-scoped scale override (bootstrap.raised_delta); the shared
        # HeContext itself is never mutated
        self._delta_override: float | None = None
        # fixed widths
        self.kq = bigint.nlimbs(ctx.q[ctx.L].bit_length())        # ct limbs at top
        self.pinv16 = bigint.digits16(
            pow(ctx.P, -1, 1 << (32 * self.kq)), 2 * self.kq)     # P^-1 mod 2^(32 kq)
        r8 = self.ring.recon(ctx.dim)
        self.rk8 = r8.ks                                          # width of r = c mod P
        self.p_half_up = self._t(bigint.int_to_limbs((ctx.P + 1) // 2, self.rk8))
        # hoisted rotations accumulate pt*perm(c1hat)*evk in the extended
        # basis, so switch keys carry extra primes covering the plaintext
        # scale (sized for gemv diagonals at Delta; the JAX engine's default
        # margin, so keys cross between the packages)
        if hoist_bits is None:
            hoist_bits = int(ctx.Delta).bit_length() + ctx.poly.logn + 8
        self.dimswk_h = min(ctx.poly.dimub,
                            ctx.dimswk + (hoist_bits + ctx.logp_prime - 1)
                            // ctx.logp_prime)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    @property
    def Delta(self) -> float:
        """Active encode scale: the context's Delta unless an engine-scoped
        override (bootstrap.raised_delta) is in effect."""
        return self.ctx.Delta if self._delta_override is None \
            else self._delta_override

    def qbits(self, l: int) -> int:
        return self.ctx.q[l].bit_length()

    def kl(self, l: int) -> int:
        return bigint.nlimbs(self.qbits(l))

    def _t(self, limbs_u32) -> torch.Tensor:
        """Host u32 limbs -> device limb tensor (a counted copy, the span
        ckks.h2d: scheme/types.py::limbs_to_torch)."""
        return limbs_to_torch(limbs_u32, self.device)

    def _cached(self, key, build, bound=()):
        """The program cached under key, built at first use, run as a graph
        per shape on a CUDA device (utils/graphs.py: the graphs share the
        ring engine's memory pool; bound: arguments read in place); its
        calls trace themselves (utils/trace.py)."""
        if key not in self._fns:
            self._fns[key] = self.ring.graphs.program(build(), key, bound)
        return self._fns[key]

    def _program(self, key, fn):
        """The program cached under key: fn at the key's first use (fn may
        close over nothing that the key does not fix)."""
        return self._cached(key, lambda: fn)

    # the add family's programs, keyed as the JAX engine caches them

    def _add2_mask(self, a, b, qb):
        return self._program(("add2", a.shape, qb),
                             lambda x, y: lb.mask_bits(lb.add(x, y), qb))(a, b)

    def _sub2_mask(self, a, b, qb):
        return self._program(("sub2", a.shape, qb),
                             lambda x, y: lb.mask_bits(lb.sub(x, y), qb))(a, b)

    def _neg_mask(self, a, qb):
        return self._program(("negm", a.shape, qb), lambda x: lb.mask_bits(lb.neg(x), qb))(a)

    # ------------------------------------------------------------------
    # encode / decode (host <-> device boundary)
    # ------------------------------------------------------------------

    def ecd(self, m: np.ndarray, nu: float | None = None) -> Plaintext:
        """Encode complex slots into an integral polynomial
        (ref: src/he-encode.c:53-64, he_ecd:107-111).  The host's build of
        the nonzero rows' limbs is the span ckks.ecd; _rows_pt lays them out."""
        ctx = self.ctx
        nu = self.Delta if nu is None else nu
        with trace.span("ckks.ecd"):
            u = invcanemb(np.asarray(m, dtype=np.complex128), ctx.slots,
                          ctx.poly.cyc_group, ctx.poly.ring_zetas, ctx.poly.m)
            gap = (ctx.poly.n // 2) // ctx.slots
            re = sample.c_round(u.real * nu)
            im = sample.c_round(u.imag * nu)
            coeff_bound = float(max(np.max(np.abs(re)), np.max(np.abs(im)), 1.0))
            vals = np.concatenate([re, im])     # the coefficients j * gap, j < 2 slots
            if np.max(np.abs(vals)) < 2**62:
                rows = bigint.i64_to_limbs(vals.astype(np.int64), self.kq)
            else:  # huge scales go through exact ints
                rows = bigint.ints_to_limbs([int(v) for v in vals], self.kq)
        return Plaintext(nu=float(nu), m=self._rows_pt(rows, gap), mod_bits=32 * self.kq,
                         bound=coeff_bound)

    def dcd(self, pt: Plaintext) -> np.ndarray:
        """Decode plaintext back to complex slots (ref: src/he-encode.c:67-74)."""
        ctx = self.ctx
        n = ctx.poly.n
        nh = n // 2
        gap = nh // ctx.slots
        vals = bigint.limbs_to_ints(limbs_to_numpy(pt.m))
        mod = 1 << pt.mod_bits
        half = mod >> 1
        cent = [(v & (mod - 1)) for v in vals]
        cent = [v - mod if v >= half else v for v in cent]
        m = np.empty(ctx.slots, dtype=np.complex128)
        for i in range(ctx.slots):
            m[i] = float(cent[i * gap]) / pt.nu + 1j * float(cent[i * gap + nh]) / pt.nu
        return canemb(m, ctx.slots, ctx.poly.cyc_group, ctx.poly.ring_zetas, ctx.poly.m)

    def canemb_norm(self, m: np.ndarray, Delta: float | None = None) -> float:
        """Canonical-embedding norm of a message (ref: src/he-encode.c:95-104)."""
        Delta = self.Delta if Delta is None else Delta
        m = np.asarray(m, dtype=np.complex128)
        u = np.concatenate([sample.c_round(m.real * Delta),
                            sample.c_round(m.imag * Delta)])
        return float(np.max(np.abs(u)))

    def canemb_norm_pt(self, pt: Plaintext) -> float:
        """Canonical-embedding norm of an encoded plaintext
        (ref: src/he-encode.c:77-92)."""
        ctx = self.ctx
        nh = ctx.poly.n // 2
        gap = nh // ctx.slots
        cent = self._poly_to_ints_signed(pt.m, pt.mod_bits)
        m = np.array([float(cent[i * gap]) + 1j * float(cent[i * gap + nh])
                      for i in range(ctx.slots)])
        m = canemb(m, ctx.slots, ctx.poly.cyc_group, ctx.poly.ring_zetas, ctx.poly.m)
        u = np.concatenate([sample.c_round(m.real), sample.c_round(m.imag)])
        return float(np.max(np.abs(u)))

    def const_pt(self, num: complex) -> Plaintext:
        """Constant plaintext (ref: src/he-encode.c:119-125): coefficients 0
        and n/2.  The host's build of their limbs is the span ckks.const_pt;
        _rows_pt lays them out."""
        with trace.span("ckks.const_pt"):
            c = [int(sample.c_round(np.float64(num.real) * self.Delta)),
                 int(sample.c_round(np.float64(num.imag) * self.Delta))]
            rows = bigint.ints_to_limbs(c, self.kq)
        return Plaintext(nu=self.Delta, m=self._rows_pt(rows, self.ctx.poly.n // 2),
                         mod_bits=32 * self.kq, bound=float(max(abs(c[0]), abs(c[1]), 1)))

    def _rows_pt(self, rows: np.ndarray, stride: int) -> torch.Tensor:
        """The [n, kq] limbs of a plaintext whose coefficient j * stride has
        the limbs rows[j] (u32 [n / stride, kq]) and whose others are 0.
        Sparse rows (stride > 1) whose limbs fit a fill's parameters (at
        most limbs_cuda.FILL_WORDS words: every const_pt, an ecd of 2 slots
        kq words) are written on the engine's device by one launch, with no
        copy and so no synchronise (ops/limbs.py::fill_rows); others (full
        packing) are laid out on the host and copied (the span ckks.h2d).
        Counted in trace.ENCODE by route."""
        if stride > 1 and rows.size <= limbs_cuda.FILL_WORDS:
            trace.ENCODE["on_card"] += 1
            return lb.fill_rows(rows, self.ctx.poly.n, stride, self.device)
        trace.ENCODE["host"] += 1
        dense = np.zeros((self.ctx.poly.n, rows.shape[1]), dtype=np.uint32)
        dense[::stride] = rows
        return self._t(dense)

    # ------------------------------------------------------------------
    # keygen (ref: src/he-kem.c)
    # ------------------------------------------------------------------

    def _poly_to_ints_signed(self, limbs, mod_bits: int) -> list[int]:
        vals = bigint.limbs_to_ints(limbs_to_numpy(limbs))
        mod = 1 << mod_bits
        half = mod >> 1
        return [(v & (mod - 1)) - mod if (v & (mod - 1)) >= half else v & (mod - 1)
                for v in vals]

    def keypair(self) -> tuple[PublicKey, SecretKey]:
        """sk + pk (ref: src/he-kem.c:43-71); sampling order sk, e, p1."""
        ctx = self.ctx
        n = ctx.poly.n
        qL = ctx.q[ctx.L]
        sk = self._t(bigint.i64_to_limbs(sample.sample_sk(self.rng, n), 1))
        e = sample.sample_error(self.rng, n)
        p1 = self._t(sample.uniform_bytes_to_limbs(
            sample.sample_uniform_bytes(self.rng, n, qL), qL.bit_length(), self.kq))
        prod = self.ring.poly_mul(sk, p1, ctx.dim, qL.bit_length(), self.kq,
                                  signed_a=32, signed_b=None)
        e_l = self._t(bigint.i64_to_limbs(e, self.kq))
        qb = qL.bit_length()
        p0 = self._program(("negadd", prod.shape, qb), lambda x, y: lb.mask_bits(
            lb.add(lb.neg(x), y), qb))(prod, e_l)
        return PublicKey(p0=p0, p1=p1), SecretKey(s=sk)

    def genswk(self, sp_ints, sk: SecretKey) -> SwitchKey:
        """Key-switching key for secret sp (ref: src/he-kem.c:74-118).
        Sampling order: e, then swkp1.  sp_ints: per-coefficient secret to
        switch FROM — a list of python ints or an int64 array.  The span
        ckks.genswk; its host seconds go to trace.SETUP["keygen_s"]."""
        ctx = self.ctx
        n = ctx.poly.n
        PqL = ctx.PqL
        t0, c0 = time.perf_counter(), trace.SETUP["capture_s"]
        with trace.span("ckks.genswk", self.device):
            e = sample.sample_error(self.rng, n)
            swk_bytes = sample.sample_uniform_bytes(self.rng, n, PqL)
            k_big = bigint.nlimbs(PqL.bit_length())
            swkp1 = self._t(sample.uniform_bytes_to_limbs(
                swk_bytes, PqL.bit_length(), k_big))
            prod_bits = 32 * (k_big + 2)
            prod = self.ring.poly_mul(swkp1, sk.s, ctx.dim_genswk(), prod_bits,
                                      k_big + 2, signed_a=None, signed_b=32)
            prod_ints = self._poly_to_ints_signed(prod, prod_bits)
            P = ctx.P
            swkp0_ints = [(-c + int(ei) + P * int(spi)) % PqL
                          for c, ei, spi in zip(prod_ints, e, sp_ints)]
            swkp0 = self._t(bigint.ints_to_limbs(swkp0_ints, k_big))
            # NTT-resident storage over the dimswk basis (ref: src/he-kem.c:103-110),
            # extended by the hoisting margin
            swk = SwitchKey(p0hat=self.ring.fwd_ntt(swkp0, self.dimswk_h),
                            p1hat=self.ring.fwd_ntt(swkp1, self.dimswk_h))
        # the first calls inside are capture_s
        trace.SETUP["keygen_s"] += time.perf_counter() - t0 - (trace.SETUP["capture_s"] - c0)
        return swk

    def genrlk(self, sk: SecretKey) -> SwitchKey:
        """Relinearization key from sk^2 (ref: src/he-kem.c:120-136)."""
        s2 = self.ring.poly_mul(sk.s, sk.s, self.ctx.dim_rlk_s2(), 64, 2,
                                signed_a=32, signed_b=32)
        s2np = limbs_to_numpy(s2).astype(np.uint64)
        s2_i64 = (s2np[:, 0] | (s2np[:, 1] << np.uint64(32))).astype(np.int64)
        return self.genswk(s2_i64, sk)

    def _sk_i64(self, sk: SecretKey) -> np.ndarray:
        """Secret-key coefficients as signed int64."""
        return limbs_to_numpy(sk.s)[:, 0].astype(np.int32).astype(np.int64)

    def genck(self, sk: SecretKey) -> SwitchKey:
        """Conjugation key from conj(sk) (ref: src/he-kem.c:139-152)."""
        sk_i = self._sk_i64(sk)
        conj = np.empty_like(sk_i)
        conj[0] = sk_i[0]
        conj[1:] = -sk_i[:0:-1]
        return self.genswk(conj, sk)

    def genrk(self, sk: SecretKey, rotations=None) -> dict[int, SwitchKey]:
        """Rotation key bank, one swk per rotation (ref: src/he-kem.c:154-169)."""
        ctx = self.ctx
        n, m = ctx.poly.n, ctx.poly.m
        sk_i = self._sk_i64(sk)
        idx = np.arange(n, dtype=np.int64)
        rots = range(ctx.slots) if rotations is None else rotations
        out = {}
        for rot in rots:
            power = pow(params.ROT, rot, m)
            k = (idx * power) % m
            wrap = k >= n
            rk_ints = np.zeros(n, dtype=np.int64)
            rk_ints[np.where(wrap, k - n, k)] = np.where(wrap, -sk_i, sk_i)
            out[rot] = self.genswk(rk_ints, sk)
        return out

    # ------------------------------------------------------------------
    # encrypt / decrypt (ref: src/he-encrypt.c)
    # ------------------------------------------------------------------

    def enc_pk(self, pt: Plaintext, pk: PublicKey) -> Ciphertext:
        """c = v*pk + (m + e0, e1) smod qL (ref: src/he-encrypt.c:37-73);
        sampling order v, e0, e1."""
        ctx = self.ctx
        n = ctx.poly.n
        qb = self.qbits(ctx.L)
        v = self._t(bigint.i64_to_limbs(sample.sample_zo(self.rng, n), 1))
        e0 = sample.sample_error(self.rng, n)
        e1 = sample.sample_error(self.rng, n)
        c0 = self.ring.poly_mul(pk.p0, v, ctx.dim, qb, self.kq,
                                signed_a=None, signed_b=32)
        c1 = self.ring.poly_mul(pk.p1, v, ctx.dim, qb, self.kq,
                                signed_a=None, signed_b=32)
        e0_l = self._t(bigint.i64_to_limbs(e0, self.kq))
        e1_l = self._t(bigint.i64_to_limbs(e1, self.kq))
        m_l = lb.resize(pt.m, self.kq)
        c0 = self._program(("add3", c0.shape, qb), lambda x, y, z: lb.mask_bits(
            lb.add(lb.add(x, y), z), qb))(c0, m_l, e0_l)
        c1 = self._add2_mask(c1, e1_l, qb)
        nu = pt.nu if pt.nu >= self.Delta else self.Delta
        return Ciphertext(l=ctx.L, nu=nu, B=ctx.bounds.Bclean, c0=c0, c1=c1)

    def enc_sk(self, pt: Plaintext, sk: SecretKey) -> Ciphertext:
        """c1 uniform, c0 = -c1*sk + m + e (ref: src/he-encrypt.c:75-103);
        sampling order e, c1."""
        ctx = self.ctx
        n = ctx.poly.n
        qb = self.qbits(ctx.L)
        e = sample.sample_error(self.rng, n)
        qL = ctx.q[ctx.L]
        c1 = self._t(sample.uniform_bytes_to_limbs(
            sample.sample_uniform_bytes(self.rng, n, qL), qL.bit_length(), self.kq))
        prod = self.ring.poly_mul(c1, sk.s, ctx.dim, qb, self.kq,
                                  signed_a=None, signed_b=32)
        e_l = self._t(bigint.i64_to_limbs(e, self.kq))
        m_l = lb.resize(pt.m, self.kq)
        c0 = self._program(("negadd3", prod.shape, qb), lambda x, y, z: lb.mask_bits(
            lb.add(lb.add(lb.neg(x), y), z), qb))(prod, m_l, e_l)
        nu = pt.nu if pt.nu >= self.Delta else self.Delta
        return Ciphertext(l=ctx.L, nu=nu, B=ctx.bounds.Bclean, c0=c0, c1=c1)

    def dec(self, ct: Ciphertext, sk: SecretKey) -> Plaintext:
        """m = c0 + c1*sk smod q_l (ref: src/he-encrypt.c:105-123)."""
        qb = self.qbits(ct.l)
        klv = self.kl(ct.l)
        prod = self.ring.poly_mul(ct.c1, sk.s, self.ctx.dim_dec(ct.l), qb, klv,
                                  signed_a=None, signed_b=32)
        m = self._add2_mask(prod, lb.resize(ct.c0, klv), qb)
        return Plaintext(nu=ct.nu, m=m, mod_bits=qb - 1)

    # ------------------------------------------------------------------
    # add family (ref: src/he-add.c)
    # ------------------------------------------------------------------

    def add(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        assert ct1.l == ct2.l, "level mismatch (ref: src/he-add.c:35)"
        qb = self.qbits(ct1.l)
        return Ciphertext(
            l=ct1.l, nu=max(ct1.nu, ct2.nu), B=ct1.B + ct2.B,
            c0=self._add2_mask(ct1.c0, ct2.c0, qb),
            c1=self._add2_mask(ct1.c1, ct2.c1, qb))

    def sub(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        assert ct1.l == ct2.l
        qb = self.qbits(ct1.l)
        return Ciphertext(
            l=ct1.l, nu=max(ct1.nu, ct2.nu), B=ct1.B + ct2.B,
            c0=self._sub2_mask(ct1.c0, ct2.c0, qb),
            c1=self._sub2_mask(ct1.c1, ct2.c1, qb))

    def neg(self, ct: Ciphertext) -> Ciphertext:
        qb = self.qbits(ct.l)
        return Ciphertext(l=ct.l, nu=ct.nu, B=ct.B,
                          c0=self._neg_mask(ct.c0, qb),
                          c1=self._neg_mask(ct.c1, qb))

    def addpt(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        qb = self.qbits(ct.l)
        c0 = self._add2_mask(ct.c0, lb.resize(pt.m, self.kl(ct.l)), qb)
        return Ciphertext(l=ct.l, nu=max(ct.nu, pt.nu), B=ct.B,
                          c0=c0, c1=lb.mask_bits(ct.c1, qb))

    def subpt(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        qb = self.qbits(ct.l)
        c0 = self._sub2_mask(ct.c0, lb.resize(pt.m, self.kl(ct.l)), qb)
        return Ciphertext(l=ct.l, nu=max(ct.nu, pt.nu), B=ct.B,
                          c0=c0, c1=lb.mask_bits(ct.c1, qb))

    # ------------------------------------------------------------------
    # multiply + relinearize (ref: src/he-mult.c)
    # ------------------------------------------------------------------

    _CLASSIC = object()  # sentinel: "single-product key-switch bound"

    def _keyswitch_core(self, dim: int, l: int, bound_bits=_CLASSIC):
        """Build the (d * swk) / P + rounding pair for level l: for the two
        halves h, stacked [2, (B,) dim, n] in the NTT domain,
        u_h = rdiv(d x swk_h, P) mod q_l via the small-CRT remainder trick
        (module docstring).

        bound_bits: proven bound on the accumulated |d x swk| coefficients
        (enables the truncated CRT reconstruct); defaults to the classic
        single-product bound ctx.bits_swk(l).  Hoisted callers accumulating
        n1 products pass their larger bound (or None to force the exact
        full-width path)."""
        ctx = self.ctx
        if bound_bits is CKKS._CLASSIC:
            bound_bits = ctx.bits_swk(l)
        ba = self.ring.ba(dim)
        plan = self.ring.recon(dim)
        ba8 = self.ring.ba(ctx.dim)
        plan8 = self.ring.recon(ctx.dim)
        # the scaled INTT emits y_d = c_d * phatinv(dim-basis)_d; the
        # sub-basis reconstruct (r = c mod P over the first ctx.dim primes)
        # needs c_d * phatinv(dim8-basis)_d, so its phatinv constant becomes
        # the RATIO phatinv8 / phatinvS per prime
        bS = ctx.poly.basis(dim)
        b8 = ctx.poly.basis(ctx.dim)
        adj = np.array(
            [b8.phat_invmp[d] * pow(bS.phat_invmp[d], p - 2, p) % p
             * params.R % p for d, p in enumerate(b8.primes)],
            dtype=np.uint64)
        ba8_adj = dataclasses.replace(ba8, phatinv_mont=u64_to_torch(adj, self.device))
        qb = self.qbits(l)
        klv = self.kl(l)
        kq = self.kq

        def post(res):
            c = rns_ops.reconstruct(res, ba, plan, center=True, k_out=kq,
                                    bound_bits=bound_bits, pre_scaled=True)
            r = rns_ops.reconstruct(res[..., :ctx.dim, :], ba8_adj, plan8,
                                    center=False, k_out=plan8.ks)
            u = lb.mul_const_mod2k(lb.sub(lb.resize(c, kq), lb.resize(r, kq)),
                                   self.pinv16, kq)
            round_bit = lb.geq_const(lb.resize(r, self.rk8), self.p_half_up)
            u = lb.add_scalar_bit(u, round_bit)
            return lb.resize(lb.mask_bits(u, qb), klv)

        def pair(uh):
            # both halves [2, (B,) dim, n] in one inverse-NTT launch, with the
            # phat^-1 reconstruct multiply fused into the INTT scaling, and
            # through post together: each of its kernels launches once
            u = post(self.ring.ntt_i(uh, dim, scale_phatinv=True))
            return u[0], u[1]
        return pair

    def mul_step_fn(self, l: int):
        """The he_mul program for level l:
        (c10, c11, c20, c21, ek0, ek1) -> (c0, c1).  The ciphertext
        arguments are [n, klv] limbs or a batch [B, n, klv] of them: the B
        pairs ride the same NTT launches ([4, B, dim_m, n] forward,
        [3, B, dim_m, n] and [2, B, dim_s, n] inverse)."""
        return self._cached(("he_mul", l), lambda: self._build_mul_step(l))

    def _mul_step(self, l: int):
        """mul_step_fn's function, for the programs that contain it
        (he_mul_rs, he_mul_rs_batch): part of theirs, not a call of its own."""
        return self.mul_step_fn(l).fn

    def _build_mul_step(self, l: int):
        ctx = self.ctx
        qb = self.qbits(l)
        klv = self.kl(l)
        dim_m = ctx.dim_mul(l)
        dim_s = ctx.dim_swk(l)
        ring = self.ring
        bam = ring.ba(dim_m)
        planm = ring.recon(dim_m)
        r2m = ring.r2(dim_m)
        bas = ring.ba(dim_s)
        r2s = ring.r2(dim_s)
        ks_pair = self._keyswitch_core(dim_s, l)
        wm = ring.weights(dim_m, klv)
        ws = ring.weights(dim_s, klv)
        pm, pvm = bam.ps[:, None], bam.pinv[:, None]
        ps, pvs = bas.ps[:, None], bas.pinv[:, None]

        def back(res):
            c = rns_ops.reconstruct(res, bam, planm, center=True, k_out=klv,
                                    bound_bits=ctx.bits_mul(l), pre_scaled=True)
            return lb.resize(lb.mask_bits(c, qb), klv)

        def f(c10, c11, c20, c21, ek0, ek1):
            # cross terms over the dim_m basis (ref: src/he-mult.c:116-138);
            # the 4 polys decomposed in one launch, their forward NTTs in one
            dec = rns_ops.decompose(torch.stack([c10, c11, c20, c21]), bam, wm)
            # (x0 y0, x0 y1 + x1 y0, x1 y1) of (x0, x1, y0, y1), stacked
            dh = cross_terms(ring.ntt_f(dec, dim_m), pm, pvm, r2m)
            # the 3 inverse NTTs likewise (phat^-1 fused into the scaling),
            # and one reconstruct of the three
            d0, d1, d2 = back(ring.ntt_i(dh, dim_m, scale_phatinv=True))
            # relinearize d2 with rlk over the dim_s basis (ref: he-mult.c:40-85)
            d2hat = ring.ntt_f(rns_ops.decompose(d2, bas, ws), dim_s)
            u0, u1 = ks_pair(key_products(d2hat, ek0[:dim_s], ek1[:dim_s], ps, pvs, r2s))
            return (lb.mask_bits(lb.add(u0, d0), qb),
                    lb.mask_bits(lb.add(u1, d1), qb))
        return f

    def _mul_meta(self, ct1: Ciphertext, ct2: Ciphertext) -> tuple[float, float]:
        nu = ct1.nu * ct2.nu
        B = (ct1.nu * ct2.B + ct2.nu * ct1.B + ct1.B * ct2.B
             + self.ctx.bounds.Bmult[ct1.l])
        return nu, B

    def mul(self, ct1: Ciphertext, ct2: Ciphertext, rlk: SwitchKey) -> Ciphertext:
        """Full ciphertext product with relinearization (ref: src/he-mult.c:88-156)."""
        assert ct1.l == ct2.l
        c0, c1 = self.mul_step_fn(ct1.l)(ct1.c0, ct1.c1, ct2.c0, ct2.c1,
                                         rlk.p0hat, rlk.p1hat)
        nu, B = self._mul_meta(ct1, ct2)
        return Ciphertext(l=ct1.l, nu=nu, B=B, c0=c0, c1=c1)

    def _rs_limbs(self, x, lnew: int):
        """Divide-round by Delta = 2^logD into level lnew's width."""
        logD = self.ctx.p.bit_length() - 1
        return lb.rshift_round_mask(x, logD, self.qbits(lnew), self.kl(lnew))

    def mul_rs(self, ct1: Ciphertext, ct2: Ciphertext,
               rlk: SwitchKey) -> Ciphertext:
        """Fused multiply + relinearize + rescale: the main path."""
        assert ct1.l == ct2.l
        l, lnew = ct1.l, ct1.l - 1

        def build():
            mul_f = self._mul_step(l)

            def f(c10, c11, c20, c21, ek0, ek1):
                c0, c1 = mul_f(c10, c11, c20, c21, ek0, ek1)
                return self._rs_limbs(c0, lnew), self._rs_limbs(c1, lnew)
            return f
        c0, c1 = self._cached(("he_mul_rs", l), build)(
            ct1.c0, ct1.c1, ct2.c0, ct2.c1, rlk.p0hat, rlk.p1hat)
        nu, B = self._mul_meta(ct1, ct2)
        return Ciphertext(l=lnew, nu=nu / self.Delta,
                          B=B / self.Delta + self.ctx.bounds.Brs, c0=c0, c1=c1)

    def mul_rs_batch_fn(self, l: int, B: int):
        """Batched fused multiply + relinearize + rescale: B independent
        ciphertext pairs through one sequence of torch calls, the NTT batch
        axis carrying 4B forward and 3B + 2B inverse transforms per launch,
        so the per-ciphertext cost amortizes (throughput, against the
        latency-oriented mul_rs).

        f(c10, c11, c20, c21, ek0, ek1) with ct args [B, n, klv]
        -> (c0, c1) [B, n, kl(l-1)].  Same math as mul_step_fn per element.
        """
        def build():
            mul_f = self._mul_step(l)

            def f(c10, c11, c20, c21, ek0, ek1):
                assert c10.shape[0] == B
                c0, c1 = mul_f(c10, c11, c20, c21, ek0, ek1)
                return self._rs_limbs(c0, l - 1), self._rs_limbs(c1, l - 1)
            return f
        return self._cached(("he_mul_rs_batch", l, B), build)

    def mul_rs_batch(self, cts1: list, cts2: list, rlk: SwitchKey) -> list:
        """Batched mul_rs over aligned ciphertext lists (one level)."""
        ctx = self.ctx
        B = len(cts1)
        l = cts1[0].l
        assert all(c.l == l for c in cts1 + cts2)
        f = self.mul_rs_batch_fn(l, B)
        c0, c1 = f(torch.stack([c.c0 for c in cts1]),
                   torch.stack([c.c1 for c in cts1]),
                   torch.stack([c.c0 for c in cts2]),
                   torch.stack([c.c1 for c in cts2]),
                   rlk.p0hat, rlk.p1hat)
        out = []
        for i, (a, b) in enumerate(zip(cts1, cts2)):
            nu, Bn = self._mul_meta(a, b)
            out.append(Ciphertext(l=l - 1, nu=nu / self.Delta,
                                  B=Bn / self.Delta + ctx.bounds.Brs,
                                  c0=c0[i], c1=c1[i]))
        return out

    def mulpt(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        """Plaintext product (ref: src/he-mult.c:159-196)."""
        ctx = self.ctx
        l = ct.l
        qb = self.qbits(l)
        klv = self.kl(l)
        dim = ctx.dim_mulpt(l, pt.size_bound)
        bits_pt = ctx.bits_mulpt(l, pt.size_bound)
        ring = self.ring
        ba = ring.ba(dim)
        plan = ring.recon(dim)

        def f(c0, c1, ptm):
            pthat = ring.ntt_f(ring.decompose(ptm, dim, 32 * ptm.shape[-1]), dim)

            def one(cx):
                ch = ring.mulmod(ring.ntt_f(ring.decompose(cx, dim), dim), pthat, dim)
                res = ring.ntt_i(ch, dim, scale_phatinv=True)
                c = rns_ops.reconstruct(res, ba, plan, center=True, k_out=klv,
                                        bound_bits=bits_pt, pre_scaled=True)
                return lb.resize(lb.mask_bits(c, qb), klv)
            return one(c0), one(c1)
        c0, c1 = self._program(("he_mulpt", l, dim, pt.m.shape[-1], bits_pt), f)(
            ct.c0, ct.c1, pt.m)
        return Ciphertext(l=l, nu=ct.nu * pt.nu, B=ct.B * pt.nu, c0=c0, c1=c1)

    # ------------------------------------------------------------------
    # rescale / moddown (ref: src/he-rescale.c)
    # ------------------------------------------------------------------

    def rs(self, ct: Ciphertext) -> Ciphertext:
        """Divide-round by Delta, drop one level (ref: src/he-rescale.c:33-54)."""
        lnew = ct.l - 1
        f = self._program(("rs", ct.l, ct.c0.shape), lambda x: self._rs_limbs(x, lnew))
        return Ciphertext(l=lnew, nu=ct.nu / self.Delta,
                          B=ct.B / self.Delta + self.ctx.bounds.Brs,
                          c0=f(ct.c0), c1=f(ct.c1))

    def moddown(self, ct: Ciphertext) -> Ciphertext:
        """Re-center mod q_{l-1} only (ref: src/he-rescale.c:56-70)."""
        lnew = ct.l - 1
        qb = self.qbits(lnew)
        klv = self.kl(lnew)
        f = self._program(("moddown", ct.l, ct.c0.shape),
                          lambda x: lb.resize(lb.mask_bits(x, qb), klv))
        return Ciphertext(l=lnew, nu=ct.nu, B=ct.B, c0=f(ct.c0), c1=f(ct.c1))

    # ------------------------------------------------------------------
    # automorphisms (ref: src/he-automorphism.c)
    # ------------------------------------------------------------------

    def _apply_swk(self, d0, d1, swk: SwitchKey, l: int) -> tuple:
        """Key switch (d0, d1): c0' = rdiv(d1*swk0, P) + d0, c1' = rdiv(d1*swk1, P)
        (ref: src/he-automorphism.c:40-85)."""
        dim_s = self.ctx.dim_swk(l)
        ring = self.ring
        qb = self.qbits(l)

        def build():
            ks_pair = self._keyswitch_core(dim_s, l)

            def f(dd0, dd1, ek0, ek1):
                dhat = ring.ntt_f(ring.decompose(dd1, dim_s), dim_s)
                # the keys hold dimswk_h rows; the slices are views
                ba = ring.ba(dim_s)
                u0, u1 = ks_pair(key_products(dhat, ek0[:dim_s], ek1[:dim_s], ba.ps[:, None],
                                              ba.pinv[:, None], ring.r2(dim_s)))
                return lb.mask_bits(lb.add(u0, dd0), qb), u1
            return f
        return self._cached(("swk", l), build)(d0, d1, swk.p0hat, swk.p1hat)

    def conj(self, ct: Ciphertext, ck: SwitchKey) -> Ciphertext:
        """Complex conjugation (ref: src/he-automorphism.c:87-100)."""
        qb = self.qbits(ct.l)
        d0 = self.ring.galois(ct.c0, None, qb)
        d1 = self.ring.galois(ct.c1, None, qb)
        c0, c1 = self._apply_swk(d0, d1, ck, ct.l)
        return Ciphertext(l=ct.l, nu=ct.nu, B=ct.B, c0=c0, c1=c1)

    def rot(self, ct: Ciphertext, r: int, rk: dict[int, SwitchKey]) -> Ciphertext:
        """Slot rotation by r (ref: src/he-automorphism.c:102-115)."""
        qb = self.qbits(ct.l)
        d0 = self.ring.galois(ct.c0, r, qb)
        d1 = self.ring.galois(ct.c1, r, qb)
        c0, c1 = self._apply_swk(d0, d1, rk[r], ct.l)
        return Ciphertext(l=ct.l, nu=ct.nu, B=ct.B, c0=c0, c1=c1)

    # ------------------------------------------------------------------
    # hoisted rotations (Halevi-Shoup double hoisting)
    # ------------------------------------------------------------------

    def bits_hoist(self, l: int, nu_sum: float) -> int:
        """Proven bound on the hoisted |c1|*|pt|*n1*|ek| accumulation."""
        ctx = self.ctx
        return int(self.qbits(l) + math.log2(max(nu_sum, 1.0))
                   + ctx.PqL.bit_length() + ctx.poly.logn + 1)

    def dim_hoist(self, l: int, nu_sum: float) -> int:
        """Extended-basis size covering the hoisted |c1|*|pt|*n1*|ek|
        accumulation (the classic relin bound of ctx.dim_swk grown by the
        plaintext-sum magnitude)."""
        return self.bits_hoist(l, nu_sum) // self.ctx.logp_prime + 1

    def gemv_dims(self, l: int, bnd_sum: float) -> tuple[int, int]:
        """(dims_h, dimc) bases for the hoisted gemv at level l."""
        return self.dim_hoist(l, bnd_sum), self.ctx.dim_mulpt(l, bnd_sum)

    def hoisted_gemv_prep_fn(self, l: int, n1: int, dims_h: int, dimc: int):
        """Hoisting prologue: decompose + NTT c0/c1 ONCE in the extended
        bases and apply all n1 baby-step Galois permutations as one gather
        (ops/ntt.py ntt_galois_perm).

        f(c0, c1) -> (c1p [n1, dims_h, n], c0p [n1, dimc, n])
        """
        return self._cached(("hoistprep", l, n1, dims_h, dimc),
                            lambda: self._build_hoisted_prep(n1, dims_h, dimc))

    def _build_hoisted_prep(self, n1: int, dims_h: int, dimc: int):
        assert self.ring.ntt_impl in ("butterfly", "pallas"), \
            "hoisted rotations need the butterfly NTT-domain ordering"
        assert dims_h <= self.dimswk_h, \
            (f"hoist basis {dims_h} exceeds switch-key limbs "
             f"{self.dimswk_h}; raise hoist_bits at engine construction")
        ring = self.ring
        logn = self.ctx.poly.logn
        perm = torch.from_numpy(np.stack(
            [ntt_galois_perm(logn, j) for j in range(n1)]).astype(np.int64)
        ).to(self.device)

        def f(c0, c1):
            c1h = ring.ntt_f(ring.decompose(c1, dims_h), dims_h)
            c0h = ring.ntt_f(ring.decompose(c0, dimc), dimc)
            # [dim, n1, n] -> [n1, dim, n]
            return (c1h[:, perm].transpose(0, 1), c0h[:, perm].transpose(0, 1))
        return f

    def hoisted_gemv_step_fn(self, l: int, dims_h: int, dimc: int,
                             bits_h: int | None = None,
                             bits_c: int | None = None):
        """BSGS-gemv giant step with double hoisting.

        The reference's gemv does a FULL key switch per baby-step rotation
        (ref: src/he-algo.c:63-85: he_rot + he_ecd + he_mulpt per (i,j)).
        Here each baby-step rotation is a pointwise multiply with the
        pre-NTT'd diagonal plaintext and rotation key, accumulated in the
        extended basis; ONE divide-round per giant step.  Exact up to the
        divide-round of the sum (a strictly smaller rounding error than the
        classic sum of n1 divide-rounds).  The caller loops giant steps with
        one plaintext slab per call, so device memory stays O(n1), not
        O(slots).

        f(c1p [n1,dims_h,n], c0p [n1,dimc,n], ptx_i [n1,dims_h,n],
          ptb_i [n1,dimc,n], rk0, rk1 [n1,>=dims_h,n]) -> (c0_i, c1_i)

        On a CUDA device its graphs read the diagonal slabs and the key
        stacks (a plan's cached constants, the path's largest arguments) in
        place: copied into static buffers they added 62% (fully hoisted) and
        21% (BSGS) to the gemv's device time on an H100 (PERF.md §6).
        """
        return self._cached(
            ("hoiststep", l, dims_h, dimc, bits_h, bits_c),
            lambda: self._build_hoisted_step(l, dims_h, dimc, bits_h, bits_c),
            bound=(2, 3, 4, 5))

    def _build_hoisted_step(self, l, dims_h, dimc, bits_h, bits_c):
        qb = self.qbits(l)
        klv = self.kl(l)
        ring = self.ring
        bas = ring.ba(dims_h)
        bac = ring.ba(dimc)
        planc = ring.recon(dimc)
        cs = bas.ps[:, None], bas.pinv[:, None], ring.r2(dims_h)
        cc = bac.ps[:, None], bac.pinv[:, None], ring.r2(dimc)
        ks_pair = self._keyswitch_core(dims_h, l, bound_bits=bits_h)

        def f(c1p, c0p, ptx_i, ptb_i, rk0, rk1):
            # all n1 baby steps as one product-and-sum each over the baby-step
            # axis, t = c1p ptx_i against both key halves; the key slices are
            # views of the stacked bank
            acc = mulmod_sum(c1p, ptx_i, *cs, ws=(rk0[:, :dims_h], rk1[:, :dims_h]))
            accb = mulmod_sum(c0p, ptb_i, *cc)[0]
            k0, k1 = ks_pair(acc)
            res = ring.ntt_i(accb, dimc, scale_phatinv=True)
            db = rns_ops.reconstruct(res, bac, planc, center=True, k_out=klv,
                                     bound_bits=bits_c, pre_scaled=True)
            db = lb.resize(lb.mask_bits(db, qb), klv)
            return lb.mask_bits(lb.add(k0, db), qb), k1
        return f
