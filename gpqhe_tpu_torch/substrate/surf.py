"""Deterministic `randombytes` stream: DJB's surf CSPRNG as used by SUPERCOP.

Byte-exact reimplementation of the reference's default RNG backend
(ref: src/rng.c:32-78, selected by -DSUPERCOP in src/Makefile:39-41).  Every
KAT in the reference pins keys/errors/messages to this stream, so the byte
sequence here must match the C code bit for bit.

The C code is scalar (one 32-byte surf() output at a time, 8 bytes consumed
per block, low byte of each out[] word, in reverse word order,
ref: src/rng.c:65-77).  Blocks only depend on the 128-bit counter ``in[0..3]``,
so we batch-generate many blocks at once with vectorized numpy u32 arithmetic
— the TPU framework consumes large sampler streams (e.g. uniform polynomials
mod P*q_L) and the scalar Python loop would dominate otherwise.
"""

from __future__ import annotations

import numpy as np

_SEED_DEFAULT = np.array(
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3,
     2, 3, 8, 4, 6, 2, 6, 4, 3, 3, 8, 3, 2, 7, 9, 5],
    dtype=np.uint32,
)

_MUSH_SHIFTS = (5, 7, 9, 13, 5, 7, 9, 13, 5, 7, 9, 13)
_GOLDEN = np.uint32(0x9E3779B9)


def _surf_batch(counters: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """Run surf() for a batch of counter values.

    counters: u32 array [4, N] — the ``in[0..3]`` words (in[4..11] stay 0, as
    the C code never touches them; ref: src/rng.c:39,69).
    Returns u8 array [N, 8]: the 8 bytes each block contributes to the stream,
    already in consumption order (out[7]&0xff first; ref: src/rng.c:71-73).
    """
    n = counters.shape[1]
    t = np.empty((12, n), dtype=np.uint32)
    # t[i] = in[i] ^ seed[12+i]; in[i>=4] == 0
    for i in range(12):
        word = counters[i] if i < 4 else np.uint32(0)
        t[i] = word ^ seed[12 + i]
    out = np.empty((8, n), dtype=np.uint32)
    for i in range(8):
        out[i] = seed[24 + i]
    x = t[11].copy()
    sum_ = np.zeros(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for _loop in range(2):
            for _r in range(16):
                sum_ += _GOLDEN
                for i, b in enumerate(_MUSH_SHIFTS):
                    # x = t[i] += (((x ^ seed[i]) + sum) ^ ROTATE(x,b))
                    rot = (x << np.uint32(b)) | (x >> np.uint32(32 - b))
                    t[i] += ((x ^ seed[i]) + sum_) ^ rot
                    x = t[i]
            for i in range(8):
                out[i] ^= t[i + 4]
    # Consumption order: out[7], out[6], ..., out[0], low byte each.
    return (out[::-1].T & np.uint32(0xFF)).astype(np.uint8)


class Surf:
    """Stateful surf stream mirroring the C globals (ref: src/rng.c:36-41)."""

    def __init__(self, seed: np.ndarray | None = None, batch: int = 4096):
        self.seed = _SEED_DEFAULT.copy() if seed is None else np.asarray(seed, dtype=np.uint32).copy()
        assert self.seed.shape == (32,)
        self.counter = 0  # number of surf blocks already generated
        self.batch = batch
        self._buf = np.empty(0, dtype=np.uint8)
        self._pos = 0

    def _refill(self, need: int) -> None:
        nblocks = max((need + 7) // 8, self.batch)
        new = None
        from . import native
        nat = native.surf_blocks(self.seed, self.counter, nblocks)
        if nat is not None:
            new = nat
        else:
            # counters for blocks counter+1 .. counter+nblocks (C increments first)
            idx = self.counter + 1 + np.arange(nblocks, dtype=np.uint64)
            ctr = np.empty((4, nblocks), dtype=np.uint32)
            for i in range(4):
                ctr[i] = ((idx >> np.uint64(32 * i)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            new = _surf_batch(ctr, self.seed).reshape(-1)
        self.counter += nblocks
        rem = self._buf[self._pos:]
        self._buf = np.concatenate([rem, new]) if rem.size else new
        self._pos = 0

    def randombytes(self, nbytes: int) -> np.ndarray:
        """Return the next nbytes of the stream as a u8 array (ref: src/rng.c:65-77)."""
        avail = self._buf.size - self._pos
        if avail < nbytes:
            self._refill(nbytes - avail)
        out = self._buf[self._pos:self._pos + nbytes]
        self._pos += nbytes
        return out


_global = None


def default_rng() -> Surf:
    """Process-global stream, like the C static state (ref: src/rng.c:36-41)."""
    global _global
    if _global is None:
        _global = Surf()
    return _global


def reset_default_rng() -> None:
    global _global
    _global = None
