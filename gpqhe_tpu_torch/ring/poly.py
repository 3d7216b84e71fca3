"""Ring engine: device composites over R_q = Z_q[X]/(X^n + 1), in torch.

Port of gpqhe_tpu/ring/poly.py (ref: src/poly.c:84-120).  Polynomials are
u32-limb tensors [n, K] (see ops/limbs.py, stored in int64); products run
decompose -> NTT -> pointwise -> INTT -> CRT-reconstruct on the engine's
device as eager torch calls.  The NTTs go through ops/ntt_cuda.py: the CUDA
kernel for every CUDA tensor, the plain twin for a CPU tensor.

Every ciphertext modulus is q_l = 2^logq_l, and 2^(32K) is a multiple of
q_l, so two's-complement limb arithmetic mod 2^(32K) preserves values mod
q_l: masking replaces the reference's big-int smod.
"""

from __future__ import annotations

import torch

from ..context import PolyContext
from ..ops import limbs as lb
from ..ops import ntt_cuda
from ..ops import rns as rns_ops
from ..ops.modmath import mulmod, u64_to_torch


class RingEngine:
    """Per-PolyContext plan caches and composites on one torch device."""

    def __init__(self, pctx: PolyContext, device=None):
        self.pctx = pctx
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._ba: dict[int, rns_ops.BasisArrays] = {}
        self._recon: dict[int, rns_ops.ReconPlan] = {}
        self._weights: dict[tuple[int, int], torch.Tensor] = {}
        self._r2: dict[int, torch.Tensor] = {}
        self._ntt: dict[int, ntt_cuda.NttPlan] = {}
        self._tables: ntt_cuda.KernelTables | None = None

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
                self._tables = ntt_cuda.make_kernel_tables(self.pctx, self.device)
            self._ntt[dim] = ntt_cuda.make_plan(self.pctx, dim, self.ba(dim),
                                                self._tables)
        return self._ntt[dim]

    # -- NTT dispatch -------------------------------------------------------

    def ntt_f(self, res, dim: int):
        """Forward NTT of [..., dim, n] residues."""
        return ntt_cuda.ntt(res, self.ntt_plan(dim))

    def ntt_i(self, res, dim: int, scale_phatinv: bool = False):
        """Inverse NTT.  scale_phatinv=True fuses the CRT reconstruct's
        per-prime phat^-1 multiply into the final n^-1 scaling (callers then
        pass pre_scaled=True to rns.reconstruct)."""
        return ntt_cuda.intt(res, self.ntt_plan(dim), scaled=scale_phatinv)

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

    # -- composites ---------------------------------------------------------

    def fwd_ntt(self, a, dim: int, signed_bits: int | None = None):
        """limbs [n, K] -> NTT-domain residues [dim, n]."""
        return self.ntt_f(self.decompose(a, dim, signed_bits), dim)

    def inv_ntt_recon(self, chat, dim: int, mask_to_bits: int, k_out: int):
        """NTT-domain residues -> centered limbs mod 2^mask_to_bits, resized
        to k_out."""
        res = self.ntt_i(chat, dim)
        c = rns_ops.reconstruct(res, self.ba(dim), self.recon(dim))
        return lb.fit_signed(c, mask_to_bits, k_out)

    def pointwise_mul(self, ahat, bhat, dim: int):
        ba = self.ba(dim)
        return mulmod(ahat, bhat, ba.ps[:, None], ba.pinv[:, None], self.r2(dim))

    def poly_mul(self, a, b, dim: int, mask_to_bits: int, k_out: int,
                 signed_a: int | None = None, signed_b: int | None = None):
        """Full negacyclic product (ref: src/poly.c:84-107) with final smod as
        a power-of-two mask.  Returns [n, k_out] limbs."""
        xh = self.fwd_ntt(a, dim, signed_a)
        yh = self.fwd_ntt(b, dim, signed_b)
        return self.inv_ntt_recon(self.pointwise_mul(xh, yh, dim), dim,
                                  mask_to_bits, k_out)
