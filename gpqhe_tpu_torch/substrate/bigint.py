"""Host-side big-integer <-> u32-limb-tensor conversions.

The TPU framework stores every "MPI-domain" polynomial (ref: src/poly.h:69-72)
as a uint32 limb tensor of shape [n, K] (little-endian limbs).  Values are
nonnegative representatives mod 2**(32*K); signed quantities use two's
complement within that width.  These helpers convert between Python ints
(exact host arithmetic, the analogue of libgcrypt MPIs) and limb tensors.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1


def nlimbs(nbits: int) -> int:
    """Number of 32-bit limbs needed for nbits bits."""
    return max(1, (nbits + LIMB_BITS - 1) // LIMB_BITS)


def int_to_limbs(x: int, k: int) -> np.ndarray:
    """One int -> u32[k], two's complement mod 2**(32k)."""
    x &= (1 << (LIMB_BITS * k)) - 1
    out = np.empty(k, dtype=np.uint32)
    for i in range(k):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def ints_to_limbs(xs, k: int) -> np.ndarray:
    """Iterable of ints -> u32[len, k], two's complement mod 2**(32k).

    Uses int.to_bytes (C speed) instead of per-limb Python arithmetic."""
    xs = list(xs)
    nbytes = 4 * k
    mod_mask = (1 << (LIMB_BITS * k)) - 1
    buf = b"".join((x & mod_mask).to_bytes(nbytes, "little") for x in xs)
    return np.frombuffer(buf, dtype=np.uint32).reshape(len(xs), k).copy()


def limbs_to_int(a: np.ndarray) -> int:
    """u32[k] -> nonnegative int."""
    x = 0
    for i in range(a.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(a[..., i])
    return x


def limbs_to_ints(a: np.ndarray) -> list:
    """u32[n, k] -> list of n nonnegative ints (int.from_bytes, C speed)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    nbytes = 4 * a.shape[1]
    buf = a.tobytes()
    return [int.from_bytes(buf[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(a.shape[0])]


def limbs_to_signed_ints(a: np.ndarray, nbits: int | None = None) -> list:
    """u32[n, k] two's complement -> list of signed ints (centered mod 2**nbits)."""
    k = a.shape[1]
    if nbits is None:
        nbits = LIMB_BITS * k
    mod = 1 << nbits
    half = mod >> 1
    vals = limbs_to_ints(a)
    return [v - mod if (v & (mod - 1)) >= half else (v & (mod - 1)) for v in vals]


def i64_to_limbs(vals: np.ndarray, k: int) -> np.ndarray:
    """int64 array [n] -> u32[n, k] two's complement (fast vectorized path)."""
    v = np.asarray(vals, dtype=np.int64).astype(np.uint64)
    out = np.empty((v.shape[0], k), dtype=np.uint32)
    out[:, 0] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if k > 1:
        out[:, 1] = (v >> np.uint64(32)).astype(np.uint32)
    sign = np.where(np.asarray(vals) < 0, np.uint32(0xFFFFFFFF), np.uint32(0))
    for i in range(2, k):
        out[:, i] = sign
    return out


def digits16(x: int, d: int) -> np.ndarray:
    """Int -> u16-digit array of length d (little-endian), as u32 dtype."""
    out = np.empty(d, dtype=np.uint32)
    for i in range(d):
        out[i] = x & 0xFFFF
        x >>= 16
    return out
