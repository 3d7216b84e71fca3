"""Canonical embedding: the slot-space special FFT with 5^i cyclic ordering.

Vectorized host (numpy complex128) port of the reference's canemb.c
(ref: src/canemb.c:43-81).  Host-side because it only touches `slots`
complex values at encode/decode boundaries — never the device hot path.
"""

from __future__ import annotations

import numpy as np


def _bitrev_permute(a: np.ndarray) -> np.ndarray:
    """In-place bit-reversal permutation (ref: src/canemb.c:28-41)."""
    n = a.shape[0]
    logn = n.bit_length() - 1
    idx = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        idx |= ((np.arange(n) >> b) & 1) << (logn - 1 - b)
    return a[idx]


def canemb(a: np.ndarray, slots: int, cyc_group: np.ndarray, ring_zetas: np.ndarray,
           m: int) -> np.ndarray:
    """Decode-direction butterflies (ref: src/canemb.c:43-60)."""
    a = _bitrev_permute(np.asarray(a, dtype=np.complex128).copy())
    length = 2
    while length <= slots:
        idx_mod = length << 2
        gap = m // idx_mod
        mid = length >> 1
        k = (cyc_group[:mid].astype(np.int64) % idx_mod) * gap
        z = ring_zetas[k]
        blocks = a.reshape(-1, length)
        u = blocks[:, :mid].copy()
        v = blocks[:, mid:] * z[None, :]
        blocks[:, :mid] = u + v
        blocks[:, mid:] = u - v
        length <<= 1
    return a


def invcanemb(a: np.ndarray, slots: int, cyc_group: np.ndarray, ring_zetas: np.ndarray,
              m: int) -> np.ndarray:
    """Encode-direction butterflies + 1/slots scaling (ref: src/canemb.c:62-81)."""
    a = np.asarray(a, dtype=np.complex128).copy()
    length = slots
    while length >= 2:
        idx_mod = length << 2
        gap = m // idx_mod
        mid = length >> 1
        k = (idx_mod - (cyc_group[:mid].astype(np.int64) % idx_mod)) * gap
        z = ring_zetas[k]
        blocks = a.reshape(-1, length)
        u = blocks[:, :mid] + blocks[:, mid:]
        v = (blocks[:, :mid] - blocks[:, mid:]) * z[None, :]
        blocks[:, :mid] = u
        blocks[:, mid:] = v
        length >>= 1
    a = _bitrev_permute(a)
    return a / slots
