"""Alternative randombytes backends: /dev/urandom and AES256-CTR-DRBG.

The reference selects one of four backends at compile time
(ref: src/rng.c:32-226): SUPERCOP surf (default, in surf.py), RANDOM
(/dev/urandom, rng.c:80-105), GCRY_RANDOM (libgcrypt, equivalent to urandom
here), and the NIST AES256-CTR-DRBG (rng.c:114-226).  AES-256 (encrypt-only
ECB) is implemented from the FIPS-197 spec — no external crypto dependency.
"""

from __future__ import annotations

import os

import numpy as np

# ---------------------------------------------------------------------------
# AES-256 (FIPS-197), encrypt-only, for the CTR-DRBG
# ---------------------------------------------------------------------------

_SBOX = None


def _build_sbox() -> bytes:
    """Generate the AES S-box from the spec (multiplicative inverse in
    GF(2^8) followed by the affine transform)."""
    def gmul(a, b):
        r = 0
        for _ in range(8):
            if b & 1:
                r ^= a
            hi = a & 0x80
            a = (a << 1) & 0xFF
            if hi:
                a ^= 0x1B
            b >>= 1
        return r

    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if gmul(x, y) == 1:
                inv[x] = y
                break
    sbox = bytearray(256)
    for x in range(256):
        v = inv[x]
        s = v
        for _ in range(4):
            v = ((v << 1) | (v >> 7)) & 0xFF
            s ^= v
        sbox[x] = s ^ 0x63
    return bytes(sbox)


def _sbox() -> bytes:
    global _SBOX
    if _SBOX is None:
        _SBOX = _build_sbox()
    return _SBOX


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def _expand_key_256(key: bytes) -> list[bytes]:
    sbox = _sbox()
    nk, nr = 8, 14
    w = [key[4 * i:4 * i + 4] for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (nr + 1)):
        t = bytearray(w[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = bytearray(sbox[b] for b in t)
            t[0] ^= rcon
            rcon = _xtime(rcon)
        elif i % nk == 4:
            t = bytearray(sbox[b] for b in t)
        w.append(bytes(a ^ b for a, b in zip(w[i - nk], t)))
    return [b"".join(w[4 * r:4 * r + 4]) for r in range(nr + 1)]


def aes256_ecb_encrypt_block(key: bytes, block: bytes) -> bytes:
    """One-block AES-256 encryption (ref: src/rng.c:133-154 uses gcrypt)."""
    sbox = _sbox()
    rks = _expand_key_256(key)
    s = bytearray(a ^ b for a, b in zip(block, rks[0]))
    for rnd in range(1, 15):
        s = bytearray(sbox[b] for b in s)                       # SubBytes
        s = bytearray(s[(i + 4 * (i % 4)) % 16] for i in range(16))  # ShiftRows (col-major)
        if rnd != 14:                                           # MixColumns
            t = bytearray(16)
            for c in range(4):
                col = s[4 * c:4 * c + 4]
                t[4 * c + 0] = _xtime(col[0]) ^ _xtime(col[1]) ^ col[1] ^ col[2] ^ col[3]
                t[4 * c + 1] = col[0] ^ _xtime(col[1]) ^ _xtime(col[2]) ^ col[2] ^ col[3]
                t[4 * c + 2] = col[0] ^ col[1] ^ _xtime(col[2]) ^ _xtime(col[3]) ^ col[3]
                t[4 * c + 3] = _xtime(col[0]) ^ col[0] ^ col[1] ^ col[2] ^ _xtime(col[3])
            s = t
        s = bytearray(a ^ b for a, b in zip(s, rks[rnd]))       # AddRoundKey
    return bytes(s)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class UrandomRng:
    """RANDOM backend (ref: src/rng.c:80-105)."""

    def randombytes(self, n: int) -> np.ndarray:
        return np.frombuffer(os.urandom(n), dtype=np.uint8)


class Aes256CtrDrbg:
    """NIST AES256-CTR-DRBG (ref: src/rng.c:114-226)."""

    def __init__(self, entropy_input: bytes, personalization: bytes | None = None):
        seed = bytearray(entropy_input[:48])
        if personalization:
            for i in range(48):
                seed[i] ^= personalization[i]
        self.key = bytes(32)
        self.v = bytes(16)
        self._update(bytes(seed))
        self.reseed_counter = 1

    def _inc_v(self) -> None:
        v = bytearray(self.v)
        for j in range(15, -1, -1):
            if v[j] == 0xFF:
                v[j] = 0
            else:
                v[j] += 1
                break
        self.v = bytes(v)

    def _update(self, provided: bytes | None) -> None:
        temp = b""
        for _ in range(3):
            self._inc_v()
            temp += aes256_ecb_encrypt_block(self.key, self.v)
        if provided is not None:
            temp = bytes(a ^ b for a, b in zip(temp, provided))
        self.key = temp[:32]
        self.v = temp[32:48]

    def randombytes(self, n: int) -> np.ndarray:
        out = bytearray()
        while len(out) < n:
            self._inc_v()
            block = aes256_ecb_encrypt_block(self.key, self.v)
            out += block[:min(16, n - len(out))]
        self._update(None)
        self.reseed_counter += 1
        return np.frombuffer(bytes(out), dtype=np.uint8)
