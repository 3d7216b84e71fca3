"""Plain CKKS decryption and decoding, written from the scheme's definition.

This is the judge's side of every cell: it takes the secret key that the
benchmark made from the seed and a ciphertext that the program produced (its
two polynomials as little-endian 32-bit limbs, its level and its scale) and
returns the complex slots the ciphertext holds.  It imports nothing of the
program.

The scheme (power-of-two CKKS, as in HEAAN and the GPQHE reference):

- the ring is Z[X]/(X^n + 1); the modulus at level l is
  q_l = 2^(logq - (L - l) logDelta), L = logq // logDelta;
- a ciphertext (c0, c1) at level l decrypts to m = c0 + c1 s mod q_l, taken
  centred in [-q_l/2, q_l/2);
- `slots` values are packed sparsely: with gap = (n/2) / slots, the
  coefficient k gap carries the real part and n/2 + k gap the imaginary
  part of u_k, scaled by nu; the slots are the evaluations
  z_j = sum_k u_k w^(k e_j), w = exp(2 pi i / (4 slots)), e_j = 5^j mod 4 slots.

Only the 2 slots coefficients that decoding reads are computed, each from
the h nonzero coefficients of the sparse ternary secret, in exact integers.
"""

from __future__ import annotations

import numpy as np


def level_bits(cfg: dict, l: int) -> int:
    """log2 q_l for the configuration's ladder."""
    L = cfg["logq"] // cfg["logDelta"]
    if not 0 <= l <= L:
        raise ValueError(f"level {l} outside 0..{L}")
    return cfg["logq"] - (L - l) * cfg["logDelta"]


def secret_key(n: int, h: int, rng: np.random.Generator) -> np.ndarray:
    """A ternary secret with min(h, n/2) coefficients in {-1, +1} at distinct
    positions, the rest 0 (int64)."""
    h = min(h, n // 2)
    s = np.zeros(n, dtype=np.int64)
    pos = rng.choice(n, size=h, replace=False)
    s[pos] = rng.choice(np.array([-1, 1], dtype=np.int64), size=h)
    return s


def _row_ints(limbs: np.ndarray, rows: np.ndarray) -> list[int]:
    """The given rows of a [n, K] array of 32-bit limbs as Python ints."""
    sel = np.ascontiguousarray(limbs[rows].astype("<u4"))
    width = 4 * sel.shape[1]
    raw = sel.tobytes()
    return [int.from_bytes(raw[i * width:(i + 1) * width], "little")
            for i in range(len(rows))]


def decrypt_coeffs(c0: np.ndarray, c1: np.ndarray, s: np.ndarray, logq: int,
                   positions: np.ndarray) -> list[int]:
    """Coefficients `positions` of c0 + c1 s mod 2^logq, centred."""
    n = c0.shape[0]
    support = np.nonzero(s)[0]
    signs = s[support]
    positions = np.asarray(positions, dtype=np.int64)
    # coefficient t of c1 * X^j is c1[t - j] for t >= j, -c1[t - j + n] below
    need = (positions[:, None] - support[None, :]) % n
    c1_rows = _row_ints(c1, need.reshape(-1))
    c0_rows = _row_ints(c0, positions)
    mod = 1 << logq
    out = []
    for a, t in enumerate(positions):
        acc = c0_rows[a]
        for b, j in enumerate(support):
            v = c1_rows[a * len(support) + b]
            acc += int(signs[b]) * (v if t >= j else -v)
        acc %= mod
        out.append(acc - mod if acc >= mod >> 1 else acc)
    return out


def decode(coeffs: list[int], nu: float, slots: int) -> np.ndarray:
    """Slots from the 2 slots packed coefficients (real parts then
    imaginary parts), scale nu."""
    u = np.array([complex(float(coeffs[k]) / nu, float(coeffs[slots + k]) / nu)
                  for k in range(slots)])
    mp = 4 * slots
    e = np.array([pow(5, j, mp) for j in range(slots)], dtype=np.int64)
    k = np.arange(slots, dtype=np.int64)
    w = np.exp(2j * np.pi * ((e[:, None] * k[None, :]) % mp) / mp)
    return w @ u


def decrypt_decode(ct: dict, s: np.ndarray, cfg: dict) -> np.ndarray:
    """The slots of one ciphertext, given as {"c0", "c1": [n, K] limbs,
    "l": level, "nu": scale}."""
    n = 1 << cfg["logn"]
    slots = cfg["slots"]
    gap = (n // 2) // slots
    pos = np.concatenate([np.arange(slots) * gap, n // 2 + np.arange(slots) * gap])
    coeffs = decrypt_coeffs(ct["c0"], ct["c1"], s, level_bits(cfg, ct["l"]), pos)
    return decode(coeffs, ct["nu"], slots)
