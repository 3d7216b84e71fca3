"""Host-side precompute: ring/RNS/HE contexts.

TPU-native equivalent of the reference's precomp.c (polyctx_init/hectx_init,
ref: src/precomp.c:328-453).  All precompute is exact host arithmetic
(Python ints); the results are exported as numpy arrays that the device
kernel layer (gpqhe_tpu.ops) uploads once per context.

Matches the reference's deterministic constructions:
  - prime chain p = 2**logp + 1, stepping 2n until prime (ref: src/precomp.c:358-375)
  - smallest-generator 2n-th roots of unity (ref: src/precomp.c:205-242)
  - bit-reversed Montgomery-domain zeta tables (ref: src/precomp.c:244-264)
  - CRT constants P, phat, phat^-1 per dim (ref: src/precomp.c:266-293)
  - modulus ladder q_l and noise bounds (ref: src/precomp.c:386-429)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from . import params
from .substrate import bigint

# ---------------------------------------------------------------------------
# number theory helpers
# ---------------------------------------------------------------------------

_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(p: int) -> bool:
    """Deterministic Miller-Rabin for p < 3.3e24 (ref: src/precomp.c:153-191,
    which uses 50 random witnesses; same verdict for 64-bit inputs)."""
    if p < 2:
        raise ValueError("input is neither prime nor composite")
    for small in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if p == small:
            return True
        if p % small == 0:
            return False
    d, r = p - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, p)
        if x in (1, p - 1):
            continue
        for _ in range(r - 1):
            x = x * x % p
            if x == p - 1:
                break
        else:
            return False
    return True


def _pollard_rho(n: int) -> int:
    if n % 2 == 0:
        return 2
    import random
    rng = random.Random(0xC0FFEE ^ n)
    while True:
        c = rng.randrange(1, n)
        f = lambda x: (x * x + c) % n
        x = y = rng.randrange(2, n)
        d = 1
        while d == 1:
            x = f(x)
            y = f(f(y))
            d = math.gcd(abs(x - y), n)
        if d != n:
            return d


def factorize(n: int) -> list[int]:
    """Prime factors of n, with multiplicity (ref: src/precomp.c:194-203; the
    reference trial-divides, we use Pollard rho for speed — same factor set)."""
    if n == 1:
        return []
    if is_prime(n):
        return [n]
    d = _pollard_rho(n)
    return sorted(factorize(d) + factorize(n // d))


def generator(p: int) -> int:
    """Smallest generator of Z_p^* (ref: src/precomp.c:205-226)."""
    phi = p - 1
    fac = sorted(set(factorize(phi)))
    g = 2
    while g <= phi:
        if all(pow(g, phi // f, p) != 1 for f in fac):
            return g
        g += 1
    raise ArithmeticError("no generator found")


def mth_root_of_unity(m: int, p: int) -> int:
    """Primitive m-th root of unity mod p (ref: src/precomp.c:235-242)."""
    phi = p - 1
    assert phi % m == 0
    return pow(generator(p), phi // m, p)


def bitrev_u32(a: int) -> int:
    """Bit-reversal of a 32-bit integer (ref: src/precomp.c:133-140)."""
    a = ((a & 0xAAAAAAAA) >> 1) | ((a & 0x55555555) << 1)
    a = ((a & 0xCCCCCCCC) >> 2) | ((a & 0x33333333) << 2)
    a = ((a & 0xF0F0F0F0) >> 4) | ((a & 0x0F0F0F0F) << 4)
    a = ((a & 0xFF00FF00) >> 8) | ((a & 0x00FF00FF) << 8)
    return ((a >> 16) | (a << 16)) & 0xFFFFFFFF


def bitrev_indices(logn: int) -> np.ndarray:
    i = np.arange(1 << logn, dtype=np.uint32)
    out = np.zeros_like(i)
    for b in range(logn):
        out |= ((i >> b) & 1) << (logn - 1 - b)
    return out


# ---------------------------------------------------------------------------
# per-prime NTT tables
# ---------------------------------------------------------------------------

@dataclass
class PrimeCtx:
    """One RNS prime with its NTT tables (ref: struct rns_ctx, src/poly.h:28-41)."""
    p: int
    pinv_mont: int          # p^-1 mod 2^64 (ref: src/reduce.c:36-48)
    ninv_mont: int          # n^-1 * R mod p (ref: src/precomp.c:248)
    r2: int                 # R^2 mod p, for exact mulmod via two Montgomery steps
    zetas: np.ndarray       # u64[n], Montgomery domain, bit-rev order (ref: src/precomp.c:244-264)
    zetas_inv: np.ndarray


def _make_prime_ctx(p: int, logn: int) -> PrimeCtx:
    n = 1 << logn
    root = mth_root_of_unity(2 * n, p)
    rootinv = pow(root, p - 2, p)
    R = params.R
    zetas = np.empty(n, dtype=np.uint64)
    zetas_inv = np.empty(n, dtype=np.uint64)
    rev = bitrev_indices(logn)
    power = 1
    power_inv = 1
    for i in range(n):
        j = int(rev[i])
        zetas[j] = power * R % p
        zetas_inv[j] = power_inv * R % p
        power = power * root % p
        power_inv = power_inv * rootinv % p
    return PrimeCtx(
        p=p,
        pinv_mont=pow(p, -1, R),
        ninv_mont=pow(n, p - 2, p) * R % p,
        r2=R * R % p,
        zetas=zetas,
        zetas_inv=zetas_inv,
    )


# ---------------------------------------------------------------------------
# RNS basis (CRT constants for a prefix of the prime chain)
# ---------------------------------------------------------------------------

@dataclass
class RnsBasis:
    """CRT constants for the first `dim` primes (ref: src/precomp.c:266-293)."""
    dim: int
    primes: list[int]
    P: int                      # product of the dim primes
    P_half: int                 # floor(P/2)
    phat: list[int]             # P / p_d
    phat_invmp: list[int]       # (P/p_d)^-1 mod p_d
    # host arrays for device upload
    ps: np.ndarray = field(default=None)            # u64[dim]
    pinv_mont: np.ndarray = field(default=None)     # u64[dim]
    ninv_mont: np.ndarray = field(default=None)     # u64[dim]
    r2: np.ndarray = field(default=None)            # u64[dim]
    phatinv_mont: np.ndarray = field(default=None)  # u64[dim]: phat^-1 * R mod p
    ninvphat_mont: np.ndarray = field(default=None)  # u64[dim]: n^-1 phat^-1 R mod p


# ---------------------------------------------------------------------------
# PolyContext
# ---------------------------------------------------------------------------

class PolyContext:
    """Ring layer context (ref: struct poly_ctx + polyctx_init, src/precomp.c:328-384)."""

    def __init__(self, logn: int, q: int, logp: int = params.LOGP,
                 dim_cap: int | None = None):
        self.logn = logn
        self.n = 1 << logn
        self.m = 2 * self.n
        self.logp = logp
        self.logq = q.bit_length() - 1
        self.logqub = params.he_std_params(logn)
        if logn < 10 or logn > 15:
            # bypass for KAT / personal parameters (ref: src/precomp.c:339-340)
            self.logqub = self.logq
        if self.logq > self.logqub:
            raise ValueError(
                f"modulus too large: logq={self.logq} > logqub={self.logqub}")
        self.q = q
        self.logR = params.LOG_R
        self.R = params.R
        # max RNS dimension (ref: src/precomp.c:357)
        self.dimub = (1 + logn + 4 * self.logqub) // logp + 1
        if dim_cap is not None:
            self.dimub = dim_cap  # test override (e.g. kernel unit tests)
        # prime chain: p = 2^logp + 1 stepping 2n (ref: src/precomp.c:358-375)
        self.primes: list[int] = []
        p = (1 << logp) + 1
        while len(self.primes) < self.dimub:
            p += 2 * self.n
            if is_prime(p):
                self.primes.append(p)
        self.prime_ctx: list[PrimeCtx] = [_make_prime_ctx(p, logn) for p in self.primes]
        # ring tables (ref: src/precomp.c:295-326)
        nh = self.n // 2
        cyc = np.empty(nh, dtype=np.uint32)
        cyc[0] = 1
        for i in range(1, nh):
            cyc[i] = (params.ROT * int(cyc[i - 1])) % self.m
        self.cyc_group = cyc
        theta = 2 * params.PI * np.arange(self.m + 1) / self.m
        self.ring_zetas = np.cos(theta) + 1j * np.sin(theta)
        self.ring_zetas[self.m] = self.ring_zetas[0]
        self._basis_cache: dict[int, RnsBasis] = {}

    def basis(self, dim: int) -> RnsBasis:
        """CRT basis over the first dim primes (ref: src/precomp.c:266-293)."""
        if dim in self._basis_cache:
            return self._basis_cache[dim]
        assert 1 <= dim <= self.dimub, (dim, self.dimub)
        primes = self.primes[:dim]
        P = 1
        for p in primes:
            P *= p
        phat = [P // p for p in primes]
        phat_invmp = [pow(ph % p, p - 2, p) for ph, p in zip(phat, primes)]
        b = RnsBasis(
            dim=dim, primes=primes, P=P, P_half=P // 2,
            phat=phat, phat_invmp=phat_invmp,
            ps=np.array(primes, dtype=np.uint64),
            pinv_mont=np.array([self.prime_ctx[i].pinv_mont for i in range(dim)], dtype=np.uint64),
            ninv_mont=np.array([self.prime_ctx[i].ninv_mont for i in range(dim)], dtype=np.uint64),
            r2=np.array([self.prime_ctx[i].r2 for i in range(dim)], dtype=np.uint64),
            phatinv_mont=np.array(
                [inv * params.R % p for inv, p in zip(phat_invmp, primes)],
                dtype=np.uint64),
            # n^-1 * phat^-1 combined: lets the INTT's final scaling also
            # perform the CRT reconstruct's phatinv multiply for free
            ninvphat_mont=np.array(
                [pow(self.n, p - 2, p) * inv % p * params.R % p
                 for inv, p in zip(phat_invmp, primes)],
                dtype=np.uint64),
        )
        self._basis_cache[dim] = b
        return b

    def zetas(self, dim: int) -> np.ndarray:
        """u64[dim, n] forward twiddles for the first dim primes."""
        return np.stack([self.prime_ctx[i].zetas for i in range(dim)])

    def zetas_inv(self, dim: int) -> np.ndarray:
        return np.stack([self.prime_ctx[i].zetas_inv for i in range(dim)])


# ---------------------------------------------------------------------------
# noise bounds
# ---------------------------------------------------------------------------

@dataclass
class Bounds:
    """Analytic noise bounds (ref: src/precomp.c:411-429)."""
    Bclean: float
    Brs: float
    Bks: float
    Bmult: list[float]


# ---------------------------------------------------------------------------
# HeContext
# ---------------------------------------------------------------------------

class HeContext:
    """CKKS scheme context (ref: struct he_ctx + hectx_init, src/precomp.c:431-453)."""

    def __init__(self, logn: int, q: int, slots: int, Delta: int,
                 logp: int = params.LOGP):
        if slots & (slots - 1):
            raise ValueError("slots must be a power of 2")
        if slots > (1 << logn) // 2:
            raise ValueError("must guarantee slots <= n/2")
        self.poly = PolyContext(logn, q, logp=logp)
        self.slots = slots
        self.Delta = float(Delta)
        self.Delta_int = int(Delta)
        self.p = int(Delta)
        # modulus ladder (ref: src/precomp.c:386-409).  The reference's
        # `ceil(logq/logDelta)` is integer division before ceil, i.e. floor.
        logq = q.bit_length() - 1
        logDelta = self.p.bit_length() - 1
        self.L = logq // logDelta
        self.q: list[int] = [0] * (self.L + 1)
        self.qh: list[int] = [0] * (self.L + 1)
        cur = q
        for l in range(self.L, -1, -1):
            self.q[l] = cur
            self.qh[l] = cur // 2
            cur //= self.p
        self.logp_prime = logp
        self.dim = (self.q[self.L].bit_length() + logn) // logp + 1
        self.P = self.poly.basis(self.dim).P
        self.PqL = self.P * self.q[self.L]
        self.dimevk = (self.q[self.L].bit_length() + self.PqL.bit_length()) // logp + 1
        # Max dim any key-switch uses (ref: src/he-mult.c:51, src/he-automorphism.c:52).
        # NOTE: at top level this exceeds the reference's dimevk by one for the
        # standard parameter sets; the reference then reads one limb past its
        # evk allocation (latent bug, ref: src/he-mem.c:42-46 vs he-mult.c:51).
        # We allocate evks at dimswk limbs so relinearization is exact.
        self.dimswk = (self.q[self.L].bit_length() + self.PqL.bit_length() + logn) // logp + 1
        if self.dimswk > self.poly.dimub:
            raise ValueError("dimswk exceeds dimub; increase logq bound")
        self.bounds = self._bounds_init()
        # Delta must dominate the clean noise (ref: src/precomp.c:452)
        assert Delta > (self.poly.n + 2 * self.bounds.Bclean), \
            "Delta too small for this ring degree"

    def _bounds_init(self) -> Bounds:
        n = self.poly.n
        h = params.BLKSIZ
        sigma = params.SIGMA
        Bclean = 8 * math.sqrt(2) * sigma * n + 6 * sigma * math.sqrt(n) \
            + 16 * sigma * math.sqrt(h * n)
        Brs = math.sqrt(n / 3.0) * (3 + 8 * math.sqrt(h))
        Bks = 8 * sigma * n / math.sqrt(3)
        # Pinv over the full dimub chain (ref: src/precomp.c:419-423)
        Pinv = 1.0
        for p in self.poly.primes:
            Pinv *= 1.0 / p
        Bmult = [0.0] * (self.L + 1)
        Pinvql = Pinv * float(self.q[0])
        Bmult[0] = Pinvql * Bks + Brs
        for l in range(1, self.L + 1):
            Pinvql *= self.Delta
            Bmult[l] = Pinvql * Bks + Brs
        return Bounds(Bclean=Bclean, Brs=Brs, Bks=Bks, Bmult=Bmult)

    # --- dim formulas used at each call site -------------------------------

    def dim_dec(self, l: int) -> int:
        """Decrypt dim.

        DIVERGES from the reference's nbits(q)/59+1 (ref: src/he-encrypt.c:113),
        which leaves only (59 - qbits%59) bits of CRT headroom for the c1*s
        product — the hwt secret makes |c1*s| up to h*q (h <= n/2), so at
        levels where qbits%59 >= 54 the lift overflows and decryption is
        garbage (observed at logq=800 ladders, level qbits=471).  The +logn
        term covers log2(h)+1 at every ring size."""
        return (self.q[l].bit_length() + self.poly.logn) // self.logp_prime + 1

    def bits_mul(self, l: int) -> int:
        """Proven bound: |cross-term coeffs| < 2^bits_mul (n products < q_l^2)."""
        return 2 * self.q[l].bit_length() + self.poly.logn

    def dim_mul(self, l: int) -> int:
        """Ciphertext multiply dim (ref: src/he-mult.c:99)."""
        return self.bits_mul(l) // self.logp_prime + 1

    def bits_swk(self, l: int) -> int:
        """Proven bound on the key-switch product d * swk_h coefficients."""
        return (self.q[l].bit_length() + self.PqL.bit_length()
                + self.poly.logn)

    def dim_swk(self, l: int) -> int:
        """Key-switch / relin dim (ref: src/he-mult.c:51, he-automorphism.c:52)."""
        return self.bits_swk(l) // self.logp_prime + 1

    def bits_mulpt(self, l: int, nu: float) -> int:
        """Proven bound on the plaintext-product coefficients."""
        return int(self.q[l].bit_length() + math.log2(max(nu, 1.0))
                   + self.poly.logn + 1)

    def dim_mulpt(self, l: int, nu: float) -> int:
        """Plaintext multiply dim (ref: src/he-mult.c:168; +1 bit so the
        fractional log2(nu) cannot eat the centered-lift sign bit)."""
        return self.bits_mulpt(l, nu) // self.logp_prime + 1

    def dim_keygen(self) -> int:
        """Keypair / enc dim (ref: src/he-kem.c:59, he-encrypt.c:58)."""
        return self.dim

    def dim_genswk(self) -> int:
        """swk generation poly_mul dim (ref: src/he-kem.c:83)."""
        return (self.PqL.bit_length() + self.poly.logn) // self.logp_prime + 1

    def dim_rlk_s2(self, ) -> int:
        """s^2 product dim in genrlk (ref: src/he-kem.c:130)."""
        return self.q[self.L].bit_length() // self.logp_prime + 1

    def kemctx(self, ssbytes: int = 0) -> dict:
        """KEM byte-size context (ref: src/precomp.c:455-463; vestigial in the
        reference — sizes computed but never used for I/O)."""
        polybytes = (self.poly.logq + 1) * self.poly.n // 8
        return {
            "polybytes": polybytes,
            "pkbytes": polybytes + params.SYMBYTES,
            "skbytes": polybytes,
            "ssbytes": (self.slots * (self.poly.n // 2) * 16
                        if self.slots else ssbytes),
        }
