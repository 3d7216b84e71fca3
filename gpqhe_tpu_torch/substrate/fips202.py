"""FIPS-202: Keccak-f[1600], SHAKE128/256, SHA3-256/512.

Capability-parity substrate for the reference's fips202.{h,c}
(ref: src/fips202.c:82-460, API src/fips202.h:19-52).  Written from the
FIPS-202 specification; validated in tests against Python's hashlib sha3/shake.

In the reference these feed the Kyber-style seeded samplers (poly_uniform /
poly_sample, ref: src/poly.c:129-261) and the symmetric XOF/PRF/KDF wrappers
(ref: src/symmetric-shake.c:47-87).  The CKKS hot path itself draws from the
surf stream instead.
"""

from __future__ import annotations

import numpy as np

SHAKE128_RATE = 168
SHAKE256_RATE = 136
SHA3_256_RATE = 136
SHA3_512_RATE = 72

_ROUNDS = 24

_RC = np.array(
    [0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
     0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
     0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
     0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
     0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
     0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
     0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
     0x8000000000008080, 0x0000000080000001, 0x8000000080008008],
    dtype=np.uint64,
)

# Rotation offsets r[x][y] of the rho step, indexed A[x + 5y].
_RHO = np.array(
    [0, 1, 62, 28, 27,
     36, 44, 6, 55, 20,
     3, 10, 43, 25, 39,
     41, 45, 15, 21, 8,
     18, 2, 61, 56, 14],
    dtype=np.uint32,
).reshape(5, 5)  # _RHO[y][x]


def _rol(a: np.ndarray, n: int) -> np.ndarray:
    n = int(n) % 64
    if n == 0:
        return a
    return (a << np.uint64(n)) | (a >> np.uint64(64 - n))


def keccak_f1600(state: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] permutation on a 25-lane u64 state (lane A[x+5y])."""
    a = state.reshape(5, 5).copy()  # a[y][x]
    with np.errstate(over="ignore"):
        for rnd in range(_ROUNDS):
            # theta
            c = a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4]          # c[x]
            d = np.roll(c, 1) ^ _rol(np.roll(c, -1), 1)   # d[x] = c[x-1] ^ rol(c[x+1],1)
            a ^= d[None, :]
            # rho + pi: b[y][2x+3y] = rol(a[y][x], r[x,y]) -> b[x][...]? use explicit loop
            b = np.empty_like(a)
            for x in range(5):
                for y in range(5):
                    b[(2 * x + 3 * y) % 5][y] = _rol(a[y][x], _RHO[y][x])
            # chi
            for y in range(5):
                t = b[y].copy()
                for x in range(5):
                    a[y][x] = t[x] ^ ((~t[(x + 1) % 5]) & t[(x + 2) % 5])
            # iota
            a[0][0] ^= _RC[rnd]
    return a.reshape(25)


class KeccakSponge:
    """Incremental sponge with a given rate and domain-separation suffix."""

    def __init__(self, rate: int, suffix: int):
        self.rate = rate
        self.suffix = suffix
        self.state = np.zeros(25, dtype=np.uint64)
        self._absorbed = 0  # bytes absorbed into current block
        self._squeezing = False

    def absorb(self, data: bytes | np.ndarray) -> None:
        assert not self._squeezing
        data = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
        pos = 0
        while pos < data.size:
            take = min(self.rate - self._absorbed, data.size - pos)
            chunk = data[pos:pos + take]
            self._xor_in(chunk, self._absorbed)
            self._absorbed += take
            pos += take
            if self._absorbed == self.rate:
                self.state = keccak_f1600(self.state)
                self._absorbed = 0

    def _xor_in(self, chunk: np.ndarray, offset: int) -> None:
        sbytes = self.state.view(np.uint8)  # little-endian lanes
        sbytes[offset:offset + chunk.size] ^= chunk

    def finalize(self) -> None:
        if self._squeezing:
            return
        sbytes = self.state.view(np.uint8)
        sbytes[self._absorbed] ^= np.uint8(self.suffix)
        sbytes[self.rate - 1] ^= np.uint8(0x80)
        self._squeezing = True
        self._sq_pos = self.rate  # force permute on first squeeze

    def squeeze(self, nbytes: int) -> bytes:
        self.finalize()
        out = bytearray()
        while len(out) < nbytes:
            if self._sq_pos == self.rate:
                self.state = keccak_f1600(self.state)
                self._sq_pos = 0
            take = min(self.rate - self._sq_pos, nbytes - len(out))
            out += self.state.view(np.uint8)[self._sq_pos:self._sq_pos + take].tobytes()
            self._sq_pos += take
        return bytes(out)

    def squeezeblocks(self, nblocks: int) -> bytes:
        """Squeeze whole rate-sized blocks (ref: src/fips202.c shakeX_squeezeblocks)."""
        return self.squeeze(nblocks * self.rate)


def shake128(out_len: int, data: bytes) -> bytes:
    sp = KeccakSponge(SHAKE128_RATE, 0x1F)
    sp.absorb(data)
    return sp.squeeze(out_len)


def shake256(out_len: int, data: bytes) -> bytes:
    sp = KeccakSponge(SHAKE256_RATE, 0x1F)
    sp.absorb(data)
    return sp.squeeze(out_len)


def sha3_256(data: bytes) -> bytes:
    sp = KeccakSponge(SHA3_256_RATE, 0x06)
    sp.absorb(data)
    return sp.squeeze(32)


def sha3_512(data: bytes) -> bytes:
    sp = KeccakSponge(SHA3_512_RATE, 0x06)
    sp.absorb(data)
    return sp.squeeze(64)


# Kyber-style symmetric wrappers (ref: src/symmetric.h, src/symmetric-shake.c:47-87)

def xof_absorb(seed: bytes, x: int) -> KeccakSponge:
    """Domain-separated SHAKE128 XOF (ref: src/symmetric-shake.c:47-60)."""
    sp = KeccakSponge(SHAKE128_RATE, 0x1F)
    sp.absorb(bytes(seed) + bytes([x]))
    return sp


def prf(out_len: int, key: bytes, nonce: int) -> bytes:
    """SHAKE256(key || nonce) (ref: src/symmetric-shake.c:62-75)."""
    return shake256(out_len, bytes(key) + bytes([nonce]))


def kdf(out_len: int, data: bytes) -> bytes:
    """SHAKE256 KDF (ref: src/symmetric-shake.c:77-87)."""
    return shake256(out_len, bytes(data))
