"""The number-theoretic-transform work that CKKS mul_rs defines at a level.

Reckoned from the context's sizes alone (ring degree, the prime width, and
the RNS bases the product and the key switch need), never from the kernels
that happen to run: it reads the same whichever backend, fusion or kernel
split implements the transforms.

One product of (c10, c11) by (c20, c21) at level l, with relinearization
and rescale:

- the cross terms: forward transforms of the 4 input polynomials over the
  dim_mul-prime basis, inverse transforms of the 3 cross terms over it;
- the relinearization of the third term: a forward transform of it over the
  dim_swk-prime basis, inverse transforms of the 2 key-switch halves over it.

Each residue row is read once and written once (8-byte words), each
direction's twiddle table is read once (one word per coefficient and prime,
over the larger basis, which holds the smaller as its prefix), a transform
row costs n/2 log2 n butterflies of one modular product each, and an inverse
row n more for its n^-1 scaling.  The least time is the larger of bytes over
the memory peak and 32-bit multiplies over the integer peak (peaks.py).
"""

from __future__ import annotations

from gpubench import peaks


def transforms(sizes: dict) -> list[tuple[str, int, int]]:
    """(direction, polynomials, primes) of the transforms of one request:
    sizes holds n, word (64 or 32), dim_mul, dim_swk and batch (the
    products one request makes)."""
    b, dm, ds = sizes["batch"], sizes["dim_mul"], sizes["dim_swk"]
    return [("fwd", 4 * b, dm), ("inv", 3 * b, dm), ("fwd", b, ds), ("inv", 2 * b, ds)]


def reckon(sizes: dict) -> dict:
    """Bytes, 32-bit multiplies and the least seconds of one request."""
    n, word = sizes["n"], sizes["word"]
    logn = n.bit_length() - 1
    nbytes = 0
    muls = 0
    table_primes = {}
    for direction, polys, dim in transforms(sizes):
        rows = polys * dim
        nbytes += 2 * rows * n * 8
        muls += rows * (n // 2) * logn
        if direction == "inv":
            muls += rows * n
        table_primes[direction] = max(table_primes.get(direction, 0), dim)
    nbytes += sum(table_primes.values()) * n * 8
    imad = muls * peaks.IMAD_PER_MULMOD[word]
    t_bytes = nbytes / peaks.PEAK_BYTES_S
    t_ops = imad / peaks.PEAK_IMAD_S
    return {"bytes": nbytes, "imad": imad, "bytes_s": t_bytes, "operations_s": t_ops,
            "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
