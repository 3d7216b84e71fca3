"""Checkpoint/serialization for keys and ciphertexts.

Port of gpqhe_tpu/utils/serialize.py: every scheme object as .npz plus a
params header for validation.  Member names, dtypes (u32 limbs, u64
NTT-resident key residues in butterfly order) and the header are the JAX
package's, so a file saved by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np

from ..context import HeContext
from ..scheme.types import from_numpy, to_numpy


def _header(ctx: HeContext) -> str:
    return json.dumps({
        "logn": ctx.poly.logn,
        "logq": ctx.poly.logq,
        "slots": ctx.slots,
        "logDelta": ctx.p.bit_length() - 1,
    })


def _check_header(ctx: HeContext, hdr: str) -> None:
    want = json.loads(_header(ctx))
    got = json.loads(hdr)
    if want != got:
        raise ValueError(f"context mismatch: file={got} ctx={want}")


def save(path: str, ctx: HeContext, obj) -> None:
    """Write a Ciphertext, Plaintext, PublicKey, SecretKey, SwitchKey or a
    rotation-key bank {rotation: SwitchKey} to path (.npz)."""
    kind, arrays = to_numpy(obj)
    np.savez_compressed(path, header=np.array(_header(ctx)), kind=np.array(kind),
                        **arrays)


def load(path: str, ctx: HeContext, device=None):
    """Read an object saved by either package; its tensors land on device
    (None means the GPU, "cuda", and raises where there is none; pass
    device="cpu" for the CPU)."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: serialize.load puts tensors on the GPU by "
                "default; pass device=\"cpu\" to load onto the CPU")
        device = "cuda"
    with np.load(path, allow_pickle=False) as z:
        _check_header(ctx, str(z["header"]))
        return from_numpy(str(z["kind"]), z, torch.device(device))
