"""Samplers consuming the deterministic surf byte stream.

Byte-order-exact host ports of the reference's sample.c (ref: src/sample.c:52-141).
Every sampler consumes exactly the same bytes in the same order as the C code,
so downstream keys/errors/messages match the reference KAT streams.
"""

from __future__ import annotations

import math

import numpy as np

from .. import params
from ..substrate.surf import Surf


def sample_z01vec(rng: Surf, m: int) -> np.ndarray:
    """Test messages in [0,1) + i[0,1) (ref: src/sample.c:52-58)."""
    buf = rng.randombytes(2 * m).astype(np.float64)
    return buf[:m] / 256.0 + 1j * buf[m:] / 256.0


def sample_discrete_gaussian(rng: Surf, m: int) -> np.ndarray:
    """Box-Muller discrete Gaussian, sigma=3.19 (ref: src/sample.c:60-72).

    The C code hits log(0) when the second byte of a pair is 0; the resulting
    +-inf passes through (int16_t)floor(...) which on x86-64 becomes 0 — we
    replicate that as an explicit 0."""
    buf = rng.randombytes(m)
    r1 = buf[0::2].astype(np.float64) / 256.0
    r2 = buf[1::2].astype(np.float64) / 256.0
    theta = 2 * params.PI * r1
    with np.errstate(divide="ignore", invalid="ignore"):
        rr = np.sqrt(-2 * np.log(r2)) * params.SIGMA
        even = np.floor(rr * np.cos(theta) + 0.5)
        odd = np.floor(rr * np.sin(theta) + 0.5)
    bad = r2 == 0.0
    even = np.where(bad, 0.0, even)
    odd = np.where(bad, 0.0, odd)
    out = np.empty(m, dtype=np.int64)
    out[0::2] = even.astype(np.int64)
    out[1::2] = odd.astype(np.int64)
    return out


def sample_error(rng: Surf, n: int) -> np.ndarray:
    """Error polynomial (ref: src/sample.c:74-82)."""
    return sample_discrete_gaussian(rng, n)


def load_nbits_le(buf: np.ndarray, nbits: int) -> int:
    """loadnbits/loadmpi little-endian semantics (ref: src/types.c:144-184):
    q full bytes plus the low r bits of the next byte."""
    q, r = divmod(nbits, 8)
    val = int.from_bytes(bytes(buf[:q]), "little")
    if r:
        val |= (int(buf[q]) & ((1 << r) - 1)) << (8 * q)
    return val


def sample_hwt(rng: Surf, n: int) -> np.ndarray:
    """Exactly-h-nonzero ternary vector, h = min(BLKSIZ, n/2)
    (ref: src/sample.c:84-100, which hardcodes h=64 and therefore never
    terminates for n < 64 — the reference never runs logn < 10; tiny test
    rings here cap h at n/2).

    Sequential by construction: byte consumption depends on index collisions;
    identical to the reference stream for n >= 128."""
    h = min(params.BLKSIZ, n // 2)
    vec = np.zeros(n, dtype=np.int64)
    num = load_nbits_le(rng.randombytes(8), 64)
    logm = n.bit_length() - 1
    idx = 0
    while idx < h:
        buf = rng.randombytes(8)
        i = load_nbits_le(buf, logm)
        if vec[i] == 0:
            vec[i] = 1 if ((num >> idx) & 1) == 0 else -1
            idx += 1
    return vec


def sample_sk(rng: Surf, n: int) -> np.ndarray:
    """Secret key (ref: src/sample.c:102-110)."""
    return sample_hwt(rng, n)


def sample_zo(rng: Surf, n: int) -> np.ndarray:
    """+-1 w.p. 1/4 each, 0 w.p. 1/2 (ref: src/sample.c:112-131)."""
    buf = rng.randombytes(2 * n // 8)
    bits = np.unpackbits(buf, bitorder="little")
    b0 = bits[0::2][:n]
    b1 = bits[1::2][:n]
    return np.where(b0 == 0, 0, np.where(b1 == 0, 1, -1)).astype(np.int64)


def sample_uniform_bytes(rng: Surf, n: int, q: int) -> np.ndarray:
    """Raw byte matrix u8[n, nbytes] behind sample_uniform: one stream draw,
    identical bytes to n per-coefficient randombytes(nbytes) calls."""
    qbits = q.bit_length()
    nbytes = qbits // 8 + 1
    return rng.randombytes(n * nbytes).reshape(n, nbytes)


def uniform_bytes_to_ints(buf: np.ndarray, qbits: int) -> list[int]:
    """Vectorized load_nbits_le over rows of u8[n, qbits//8+1]."""
    nq, r = divmod(qbits, 8)
    rows = np.ascontiguousarray(buf[:, :nq]).tobytes()
    step = nq
    out = [int.from_bytes(rows[i * step:(i + 1) * step], "little")
           for i in range(buf.shape[0])]
    if r:
        top = (buf[:, nq].astype(np.uint64) & np.uint64((1 << r) - 1))
        shift = 8 * nq
        out = [v | (int(t) << shift) for v, t in zip(out, top)]
    return out


def uniform_bytes_to_limbs(buf: np.ndarray, qbits: int, k: int) -> np.ndarray:
    """Vectorized load_nbits_le -> u32[n, k] limb tensor (no python ints)."""
    nq, r = divmod(qbits, 8)
    n = buf.shape[0]
    full = np.zeros((n, 4 * k), dtype=np.uint8)
    full[:, :nq] = buf[:, :nq]
    if r:
        full[:, nq] = buf[:, nq] & ((1 << r) - 1)
    return full.view(np.uint32).reshape(n, k)


def sample_uniform_ints(rng: Surf, n: int, q: int) -> list[int]:
    """Uniform mod-q-width coefficients (ref: src/sample.c:133-141).

    Draws nbits(q) bits per coefficient; values are in [0, 2^nbits(q)), which
    may exceed q — the reference stores them unreduced too."""
    return uniform_bytes_to_ints(sample_uniform_bytes(rng, n, q), q.bit_length())


def poly_uniform(n: int, seed: bytes, q: int, blksiz: int = params.BLKSIZ) -> np.ndarray:
    """Kyber-style seeded uniform sampler via SHAKE128 rejection
    (ref: src/poly.c:129-155; unused by the HE path but part of the surface).

    Generates n coefficients in blocks of blksiz, domain-separating each
    block with its index, rejecting 16-bit candidates >= 5*q."""
    from ..substrate import fips202

    out = np.zeros(n, dtype=np.uint64)
    bound = 5 * q
    for i in range(n // blksiz):
        sp = fips202.KeccakSponge(fips202.SHAKE128_RATE, 0x1F)
        sp.absorb(bytes(seed) + bytes([i]))
        ctr = 0
        while ctr < blksiz:
            buf = sp.squeezeblocks(1)
            for j in range(0, fips202.SHAKE128_RATE - 1, 2):
                if ctr >= blksiz:
                    break
                val = buf[j] | (buf[j + 1] << 8)
                if val < bound:
                    out[i * blksiz + ctr] = val
                    ctr += 1
    return out


def _hw(a: int) -> int:
    return bin(a & 0xFF).count("1")


def poly_sample(n: int, seed: bytes, nonce: int, blksiz: int = params.BLKSIZ) -> np.ndarray:
    """Kyber/NewHope-style CBD sampler via SHAKE256 (ref: src/poly.c:201-261;
    Hamming-weight difference of byte pairs plus the cbd() overwrite quirk —
    the reference writes both r[64i+j] and r[64i+j/2(+1)], last write wins)."""
    from ..substrate import fips202

    out = np.zeros(n, dtype=np.int64)
    for i in range(n // blksiz):
        buf = fips202.shake256(blksiz * 2, bytes(seed) + bytes([nonce, i]))
        for j in range(blksiz):
            out[blksiz * i + j] = _hw(buf[2 * j]) - _hw(buf[2 * j + 1])
            t = int.from_bytes(buf[j:j + 4], "little")
            d = 0
            for k in range(8):
                d += (t >> k) & 0x01010101
            a, b = d & 0xFF, (d >> 8) & 0xFF
            c, e = (d >> 16) & 0xFF, (d >> 24) & 0xFF
            out[blksiz * i + j // 2] = a - b
            out[blksiz * i + j // 2 + 1] = c - e
    return out


def c_round(x: np.ndarray) -> np.ndarray:
    """C round(): ties away from zero (numpy rounds half-to-even)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def gaussian_pdf_check(vec: np.ndarray) -> float:
    """Helper for sampler sanity tests: empirical std."""
    return float(np.std(vec.astype(np.float64)))
