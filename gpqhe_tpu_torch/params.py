"""Compile-time-style parameters of the framework.

Mirrors the knobs of the reference implementation (ref: src/params.h:26-56,
src/config.h:58-59) as module constants.  Unlike the reference these can be
overridden per-context where meaningful (e.g. ``logp`` for the shrunken-prime
CRT debug mode, ref: src/params.h:30-33).
"""

# Each RNS prime is slightly above 2**LOGP (ref: src/params.h:27).
LOGP = 59

# Shrunken-prime debug mode uses 9-bit primes (ref: src/params.h:30-33,
# tests/Makefile:23-29).  Select by passing logp=9 to PolyContext.
LOGP_TEST_CRT = 9

# 'C' classical or 'Q' quantum security table (ref: src/params.h:39).
SEC_CQ = "C"

# Security level in bits: 128, 192 or 256 (ref: src/params.h:46).
SEC_LEVEL = 128

# Block size; doubles as the secret-key Hamming weight h (ref: src/params.h:49,
# src/sample.c:84-100, src/precomp.c:413).
BLKSIZ = 64

# Size in bytes of hashes and seeds (ref: src/params.h:50).
SYMBYTES = 32

PI = 3.141592653589793238462643383279502884

# Rotation generator of the cyclic group (ref: src/params.h:54).
ROT = 5

# Discrete-Gaussian sigma (ref: src/params.h:55).
SIGMA = 3.1915382432114616

# Montgomery radix R = 2**64 (ref: src/precomp.c:354-356).
LOG_R = 64
R = 1 << 64
R_MASK = R - 1

# Security table: upper bound of log(q) per logn (ref: src/precomp.c:53-117).
# Keyed by (CQ, sec_level) -> {logn: logq_ub}.
HE_STD_PARAMS = {
    ("C", 128): {10: 27, 11: 54, 12: 109, 13: 218, 14: 438, 15: 881},
    ("C", 192): {10: 19, 11: 37, 12: 75, 13: 152, 14: 305, 15: 611},
    ("C", 256): {10: 14, 11: 29, 12: 58, 13: 118, 14: 237, 15: 476},
    ("Q", 128): {10: 25, 11: 51, 12: 101, 13: 202, 14: 411, 15: 827},
    ("Q", 192): {10: 17, 11: 35, 12: 70, 13: 141, 14: 284, 15: 571},
    ("Q", 256): {10: 13, 11: 27, 12: 54, 13: 109, 14: 220, 15: 443},
}


def he_std_params(logn: int, cq: str = SEC_CQ, sec_level: int = SEC_LEVEL) -> int:
    """Upper bound of logq for a given ring degree (ref: src/precomp.c:53-117).

    Returns 0 when logn is outside the table, matching the reference which then
    bypasses the bound (ref: src/precomp.c:338-340).
    """
    return HE_STD_PARAMS.get((cq, sec_level), {}).get(logn, 0)
