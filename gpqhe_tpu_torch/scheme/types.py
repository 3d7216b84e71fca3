"""CKKS object types: plaintext, ciphertext, keys, on torch tensors.

Port of gpqhe_tpu/scheme/types.py (ref: src/gpqhe.h:72-97).  Ciphertexts
carry (level l, message norm nu, noise bound B) host-side; polynomial data
lives on the engine's device as u32-limb tensors [n, K] stored in int64.
Switch keys are the only objects kept in the NTT/RNS domain: [dimswk_h, n]
residues in the butterfly NTT order that both packages share.

from_numpy / to_numpy convert to and from the array layout that
utils/serialize.py writes, here and in the JAX package (u32 limbs, u64
NTT-resident keys, a rotation-key bank as 'rots' plus one p0hat_r / p1hat_r
pair per rotation), so keys and ciphertexts cross between the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.modmath import torch_to_u64, u64_to_torch
from ..utils import trace


@dataclass
class Plaintext:
    """nu = encode scale; m = limb tensor [n, K], two's complement mod
    2^mod_bits.  bound = max |coefficient| (None means nu)."""
    nu: float
    m: torch.Tensor
    mod_bits: int
    bound: float | None = None

    @property
    def size_bound(self) -> float:
        return self.nu if self.bound is None else max(self.nu, self.bound)


@dataclass
class Ciphertext:
    """(l, nu, B) + c0, c1 limb tensors [n, K_l] holding nonnegative
    representatives mod 2^nbits(q_l)."""
    l: int
    nu: float
    B: float
    c0: torch.Tensor
    c1: torch.Tensor

    def copy(self) -> "Ciphertext":
        return Ciphertext(self.l, self.nu, self.B, self.c0, self.c1)


@dataclass
class PublicKey:
    """(p0, p1) limb tensors [n, K_L]."""
    p0: torch.Tensor
    p1: torch.Tensor


@dataclass
class SecretKey:
    """Ternary hwt-64 key as signed limbs [n, 1]."""
    s: torch.Tensor


@dataclass
class SwitchKey:
    """Key-switching key, NTT-resident over the dimswk_h-prime basis:
    [dimswk_h, n] residues per half."""
    p0hat: torch.Tensor
    p1hat: torch.Tensor


def limbs_to_torch(a, device=None) -> torch.Tensor:
    """Host u32 limbs -> int64 tensor on device: the span ckks.h2d, its
    bytes and copies counted in utils/trace.py::H2D on every device."""
    with trace.span("ckks.h2d", device):
        t = torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64))
        trace.H2D["bytes"] += t.nbytes
        trace.H2D["copies"] += 1
        return t.to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 limb tensor -> host u32 limbs."""
    return t.detach().cpu().numpy().astype(np.uint32)


_LIMB_FIELDS = {"ct": ("c0", "c1"), "pt": ("m",), "pk": ("p0", "p1"), "sk": ("s",)}


def from_numpy(kind: str, arrays: dict, device):
    """Arrays in the serialize.py layout -> object on device (the caller
    names it: utils/serialize.py's load owns the default, the GPU).  kind is
    one of 'ct', 'pt', 'pk', 'sk', 'swk', 'rk' (a rotation-key bank, returned
    as {rotation: SwitchKey}); 'ct' and 'pt' also take 'meta'."""
    if kind == "swk":
        return SwitchKey(p0hat=u64_to_torch(arrays["p0hat"], device),
                         p1hat=u64_to_torch(arrays["p1hat"], device))
    if kind == "rk":
        return {int(r): SwitchKey(
            p0hat=u64_to_torch(arrays[f"p0hat_{int(r)}"], device),
            p1hat=u64_to_torch(arrays[f"p1hat_{int(r)}"], device))
            for r in arrays["rots"]}
    if kind not in _LIMB_FIELDS:
        raise ValueError(f"unknown kind {kind!r}")
    t = {f: limbs_to_torch(arrays[f], device) for f in _LIMB_FIELDS[kind]}
    if kind == "ct":
        l, nu, B = np.asarray(arrays["meta"], dtype=np.float64)
        return Ciphertext(l=int(l), nu=float(nu), B=float(B), **t)
    if kind == "pt":
        nu, mod_bits = np.asarray(arrays["meta"], dtype=np.float64)
        return Plaintext(nu=float(nu), mod_bits=int(mod_bits), **t)
    return PublicKey(**t) if kind == "pk" else SecretKey(**t)


def to_numpy(obj) -> tuple[str, dict]:
    """Object -> (kind, arrays) in the serialize.py layout."""
    if isinstance(obj, SwitchKey):
        return "swk", {"p0hat": torch_to_u64(obj.p0hat),
                       "p1hat": torch_to_u64(obj.p1hat)}
    if isinstance(obj, dict):  # rotation-key bank
        arrays = {"rots": np.array(sorted(obj))}
        for r, swk in obj.items():
            arrays[f"p0hat_{r}"] = torch_to_u64(swk.p0hat)
            arrays[f"p1hat_{r}"] = torch_to_u64(swk.p1hat)
        return "rk", arrays
    kind = {Ciphertext: "ct", Plaintext: "pt", PublicKey: "pk",
            SecretKey: "sk"}.get(type(obj))
    if kind is None:
        raise TypeError(type(obj))
    arrays = {f: limbs_to_numpy(getattr(obj, f)) for f in _LIMB_FIELDS[kind]}
    if kind == "ct":
        arrays["meta"] = np.array([obj.l, obj.nu, obj.B], dtype=np.float64)
    elif kind == "pt":
        arrays["meta"] = np.array([obj.nu, obj.mod_bits], dtype=np.float64)
    return kind, arrays
