"""Ring engine: device composites over R_q = Z_q[X]/(X^n + 1), in torch.

Port of gpqhe_tpu/ring/poly.py (ref: src/poly.c:84-120).  Polynomials are
u32-limb tensors [n, K] (see ops/limbs.py, stored in int64); products run
decompose -> NTT -> pointwise -> INTT -> CRT-reconstruct on the engine's
device as eager torch calls.  The NTTs go through ops/ntt_cuda.py (primes
of up to 60 bits) or ops/ntt_cuda32.py (a chain whose primes are all below
2^30, i.e. logp <= 29): the CUDA kernel for every CUDA tensor, the plain
twin for a CPU tensor.

Every ciphertext modulus is q_l = 2^logq_l, and 2^(32K) is a multiple of
q_l, so two's-complement limb arithmetic mod 2^(32K) preserves values mod
q_l: masking replaces the reference's big-int smod.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import params
from ..context import PolyContext
from ..ops import limbs as lb
from ..ops import ntt_cuda, ntt_cuda32
from ..ops import rns as rns_ops
from ..ops.modmath import mulmod, u64_to_torch
from ..utils import trace


def ntt_module(pctx: PolyContext):
    """The NTT binding that serves a chain: the single-word u32 kernel where
    the largest prime is below 2^30 (4p fits a u32 word), else the u64 one."""
    return ntt_cuda32 if pctx.primes[pctx.dimub - 1] < (1 << 30) else ntt_cuda


class RingEngine:
    """Per-PolyContext plan caches and composites on one torch device.

    device=None means the GPU ("cuda") and raises where there is none; CPU
    callers pass device="cpu"."""

    def __init__(self, pctx: PolyContext, device=None):
        self.pctx = pctx
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: gpqhe_tpu_torch engines run on the GPU by "
                    "default; pass device=\"cpu\" to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.ntt_mod = ntt_module(pctx)
        self._ba: dict[int, rns_ops.BasisArrays] = {}
        self._recon: dict[int, rns_ops.ReconPlan] = {}
        self._weights: dict[tuple[int, int], torch.Tensor] = {}
        self._r2: dict[int, torch.Tensor] = {}
        self._ntt: dict[int, ntt_cuda.NttPlan] = {}
        self._tables: ntt_cuda.KernelTables | None = None
        self._galois: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    # -- plan caches --------------------------------------------------------

    def ba(self, dim: int) -> rns_ops.BasisArrays:
        if dim not in self._ba:
            self._ba[dim] = rns_ops.make_basis_arrays(self.pctx, dim, self.device)
        return self._ba[dim]

    def recon(self, dim: int) -> rns_ops.ReconPlan:
        if dim not in self._recon:
            self._recon[dim] = rns_ops.make_recon_plan(self.pctx, dim, self.device)
        return self._recon[dim]

    def weights(self, dim: int, k: int) -> torch.Tensor:
        if (dim, k) not in self._weights:
            self._weights[(dim, k)] = u64_to_torch(
                rns_ops.make_decomp_weights(self.pctx, dim, k), self.device)
        return self._weights[(dim, k)]

    def r2(self, dim: int) -> torch.Tensor:
        """[dim, 1] R^2 mod p per prime (the mulmod constant)."""
        if dim not in self._r2:
            self._r2[dim] = u64_to_torch(self.pctx.basis(dim).r2, self.device)[:, None]
        return self._r2[dim]

    def ntt_plan(self, dim: int) -> ntt_cuda.NttPlan:
        if dim not in self._ntt:
            if self.device.type == "cuda" and self._tables is None:
                self._tables = self.ntt_mod.make_kernel_tables(self.pctx, self.device)
            self._ntt[dim] = self.ntt_mod.make_plan(self.pctx, dim, self.ba(dim),
                                                    self._tables)
        return self._ntt[dim]

    def galois_map(self, rot: int | None) -> tuple[torch.Tensor, torch.Tensor]:
        """(src_index [n], neg_flag [n]) for output slot k, on the device.
        rot=None means conjugation.

        poly_rot: k = i*5^rot mod 2n, sign flip above n (ref: src/poly.c:263-276);
        poly_conj: r[0]=a[0], r[i]=-a[n-i] (ref: src/poly.c:278-283)."""
        key = -1 if rot is None else rot
        if key not in self._galois:
            n, m = self.pctx.n, self.pctx.m
            i = np.arange(n, dtype=np.int64)
            src = np.empty(n, dtype=np.int64)
            negf = np.empty(n, dtype=bool)
            if rot is None:
                src[0], negf[0] = 0, False
                src[1:], negf[1:] = n - i[1:], True
            else:
                k = (i * pow(params.ROT, rot, m)) % m
                wrap = k >= n
                dst = np.where(wrap, k - n, k)
                src[dst] = i
                negf[dst] = wrap
            self._galois[key] = (torch.from_numpy(src).to(self.device),
                                 torch.from_numpy(negf).to(self.device))
        return self._galois[key]

    # -- NTT dispatch -------------------------------------------------------

    def ntt_f(self, res, dim: int):
        """Forward NTT of [..., dim, n] residues."""
        return self.ntt_mod.ntt(res, self.ntt_plan(dim))

    def ntt_i(self, res, dim: int, scale_phatinv: bool = False):
        """Inverse NTT.  scale_phatinv=True fuses the CRT reconstruct's
        per-prime phat^-1 multiply into the final n^-1 scaling (callers then
        pass pre_scaled=True to rns.reconstruct)."""
        return self.ntt_mod.intt(res, self.ntt_plan(dim), scaled=scale_phatinv)

    # -- decompose variants -------------------------------------------------

    def _decompose_unsigned(self, a, dim: int):
        return rns_ops.decompose(a, self.ba(dim), self.weights(dim, a.shape[-1]))

    def _decompose_signed(self, a, dim: int, src_bits: int):
        """Two's-complement input of src_bits width -> residues honouring sign."""
        ps = self.ba(dim).ps[:, None]
        hb_limb, hb_bit = divmod(src_bits - 1, 32)
        negmask = ((a[..., hb_limb] >> hb_bit) & 1) == 1
        mag = lb.select(negmask, lb.mask_bits(lb.neg(a), src_bits), a)
        res = self._decompose_unsigned(mag, dim)
        neg_res = torch.where(res != 0, ps - res, res)
        return torch.where(negmask[..., None, :], neg_res, res)

    def decompose(self, a, dim: int, signed_bits: int | None = None):
        if signed_bits is None:
            return self._decompose_unsigned(a, dim)
        return self._decompose_signed(a, dim, signed_bits)

    def mulmod(self, ahat, bhat, dim: int):
        """Pointwise product of NTT-domain residues over the dim basis."""
        ba = self.ba(dim)
        return mulmod(ahat, bhat, ba.ps[:, None], ba.pinv[:, None], self.r2(dim))

    def _inv_recon(self, chat, dim: int, mask_to_bits: int, k_out: int):
        res = self.ntt_i(chat, dim)
        c = rns_ops.reconstruct(res, self.ba(dim), self.recon(dim))
        return lb.fit_signed(c, mask_to_bits, k_out)

    # -- composites ---------------------------------------------------------
    # Each is one program of the JAX ring engine and is counted by an op
    # trace under that program's cache-key head (utils/trace.py); inside,
    # they and the scheme engine's programs call decompose / ntt_f / mulmod
    # / _inv_recon, which no trace counts.

    def fwd_ntt(self, a, dim: int, signed_bits: int | None = None):
        """limbs [n, K] -> NTT-domain residues [dim, n]."""
        return trace.maybe_wrap(("fwd",), lambda x: self.ntt_f(
            self.decompose(x, dim, signed_bits), dim))(a)

    def inv_ntt_recon(self, chat, dim: int, mask_to_bits: int, k_out: int):
        """NTT-domain residues -> centered limbs mod 2^mask_to_bits, resized
        to k_out."""
        return trace.maybe_wrap(("invrec",), lambda ch: self._inv_recon(
            ch, dim, mask_to_bits, k_out))(chat)

    def pointwise_mul(self, ahat, bhat, dim: int):
        return trace.maybe_wrap(("pw",), lambda x, y: self.mulmod(x, y, dim))(ahat, bhat)

    def poly_mul(self, a, b, dim: int, mask_to_bits: int, k_out: int,
                 signed_a: int | None = None, signed_b: int | None = None):
        """Full negacyclic product (ref: src/poly.c:84-107) with final smod as
        a power-of-two mask.  Returns [n, k_out] limbs."""
        def f(x, y):
            xh = self.ntt_f(self.decompose(x, dim, signed_a), dim)
            yh = self.ntt_f(self.decompose(y, dim, signed_b), dim)
            return self._inv_recon(self.mulmod(xh, yh, dim), dim, mask_to_bits, k_out)
        return trace.maybe_wrap(("mul",), f)(a, b)

    def galois(self, a, rot: int | None, q_bits: int):
        """Apply the rot/conj automorphism to limbs [..., n, K] mod 2^q_bits: a
        row gather, then negation of the rows that wrapped past X^n = -1."""
        src, negf = self.galois_map(rot)

        def f(x):
            g = x[..., src, :]
            return torch.where(negf[:, None], lb.mask_bits(lb.neg(g), q_bits),
                               lb.mask_bits(g, q_bits))
        return trace.maybe_wrap(("gal",), f)(a)
