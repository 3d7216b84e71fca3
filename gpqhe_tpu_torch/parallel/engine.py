"""Mesh-mode scheme engine: whole compositions on a (limb, coeff, batch) mesh.

Port of gpqhe_tpu/parallel/engine.py.  MeshCKKS routes the key-switch-heavy
scheme ops — rot/conj, fused mul+relin+rescale, and the hoisted-gemv giant
step — through the sharded programs of parallel/mesh.py, so COMPOSITIONS
built from public engine ops (gemv_hoisted, coeff2slot, bootstrap stages)
execute on the mesh end-to-end.  Everything else (add/sub/rs/moddown, mulpt,
keygen, encode, the hoisting prologue) is inherited and runs on this
process's first device, where every sharded program leaves its gathered
output.  On a mesh that spans processes every rank runs the same
composition in lockstep: the inherited ops are replicated, the sharded
programs walk each rank's own positions.

Everything is BIT-IDENTICAL to the single-device CKKS engine: the sharded
programs are exactness-tested against the engine's, and the one
representational difference — gemv bases padded to limb-axis multiples via
gemv_dims() — only enlarges CRT ranges (the reconstructed integers are
unchanged).

The reference has no counterpart to any of this (its pthread parallel code
is compiled out, ref: src/rns.c:79-216); the mesh axes are the natural
parallel axes of its RNS pipeline (SURVEY.md §2).
"""

from __future__ import annotations

import torch

from ..scheme.engine import CKKS
from ..scheme.types import Ciphertext, SwitchKey
from . import mesh as mesh_ops


class MeshCKKS(CKKS):
    """CKKS engine that executes rot/conj/mul_rs and the hoisted-gemv step
    as (limb, coeff, batch)-sharded programs on the given mesh.  The
    engine's own device is this process's first device of the mesh."""

    def __init__(self, ctx, mesh: mesh_ops.HeMesh, **kw):
        if kw.get("ntt_impl", "butterfly") == "matmul":
            # the sharded programs run the butterfly NTT on coefficient
            # shards (parallel/mesh.py): on keys held in the four-step order
            # they would decode wrong, as the JAX package's mesh does
            raise ValueError("MeshCKKS does not take ntt_impl='matmul': its sharded programs "
                             "run the butterfly NTT, whose order the four-step NTT's keys "
                             "do not have")
        device = kw.pop("device", None)
        if device is not None and torch.device(device) != mesh.first_device:
            raise ValueError(f"device={device} contradicts the mesh, whose first device is "
                             f"{mesh.first_device}")
        super().__init__(ctx, device=mesh.first_device, **kw)
        self.mesh = mesh
        self._mesh_jit = {}

    def _mcached(self, key, build):
        """The sharded program cached under key, built at first use (on a
        graphable mesh a CUDA graph per shape in the ring engine's pool:
        parallel/mesh.py), traced under the name of the single-device
        engine's program."""
        if key not in self._mesh_jit:
            self._mesh_jit[key] = build()
        return self._mesh_jit[key]

    def _pad_limb(self, dim: int) -> int:
        return mesh_ops._pad_dim(dim, self.mesh.shape["limb"],
                                 self.ctx.poly.dimub)

    # -- gemv basis padding (see CKKS.gemv_dims) ------------------------
    def gemv_dims(self, l: int, bnd_sum: float):
        dims_h, dimc = super().gemv_dims(l, bnd_sum)
        return self._pad_limb(dims_h), self._pad_limb(dimc)

    # -- sharded scheme ops --------------------------------------------
    def mul_rs(self, ct1: Ciphertext, ct2: Ciphertext,
               rlk: SwitchKey) -> Ciphertext:
        assert ct1.l == ct2.l
        l = ct1.l
        # each program takes one ciphertext and runs it on every batch
        # position (prefer batch=1 meshes for single-ciphertext workloads)
        f = self._mcached(("mul_rs", l), lambda: mesh_ops.build_sharded_mul_rs(
            self, l, self.mesh))
        c0, c1 = f(ct1.c0, ct1.c1, ct2.c0, ct2.c1, rlk.p0hat, rlk.p1hat)
        nu, B = self._mul_meta(ct1, ct2)
        return Ciphertext(l=l - 1, nu=nu / self.Delta,
                          B=B / self.Delta + self.ctx.bounds.Brs, c0=c0, c1=c1)

    def _rot_sharded(self, ct: Ciphertext, r: int | None,
                     swk: SwitchKey) -> Ciphertext:
        f = self._mcached(("rot", ct.l, r), lambda: mesh_ops.build_sharded_rot(
            self, ct.l, self.mesh, r))
        c0, c1 = f(ct.c0, ct.c1, swk.p0hat, swk.p1hat)
        return Ciphertext(l=ct.l, nu=ct.nu, B=ct.B, c0=c0, c1=c1)

    def rot(self, ct: Ciphertext, r: int, rk: dict[int, SwitchKey]) -> Ciphertext:
        return self._rot_sharded(ct, r, rk[r])

    def conj(self, ct: Ciphertext, ck: SwitchKey) -> Ciphertext:
        return self._rot_sharded(ct, None, ck)

    # -- sharded hoisted-gemv giant step -------------------------------
    def hoisted_gemv_step_fn(self, l: int, dims_h: int, dimc: int,
                             bits_h: int | None = None,
                             bits_c: int | None = None):
        # bits_h/bits_c select the single-device TRUNCATED reconstruct fast
        # path; the sharded program always takes the exact full-width path,
        # which yields identical values under the same proven bounds.
        return self._mcached(
            ("gemvstep", l, dims_h, dimc),
            lambda: mesh_ops.build_sharded_gemv_step(
                self, l, None, dims_h, dimc, self.mesh))
