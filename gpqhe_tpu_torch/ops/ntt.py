"""Batched negacyclic NTT / INTT over a stack of RNS primes, in plain torch.

Port of gpqhe_tpu/ops/ntt.py: each stage is one vectorized butterfly over the
whole [..., dim, n] residue tensor, with Montgomery-domain bit-reversed
twiddles (ref: src/ntt.c:37-73, src/precomp.c:244-264).  This is the plain
twin of the CUDA kernel in ops/ntt_cuda.py: the CPU path runs it, and the
kernel is held bit-equal to it on the card, so it uses only the plain
modmath versions: pure torch on any device.

Shapes:
  a:      int64[..., dim, n]   residues per prime (leading batch dims allowed)
  zetas:  int64[dim, n]
  ps:     int64[dim]
  pinv:   int64[dim]           (u64 bit patterns)
"""

from __future__ import annotations

import numpy as np
import torch

from .modmath import plain_addmod, plain_mont_mul, plain_submod


def ntt(a, zetas, ps, pinv):
    """Forward negacyclic NTT, in bit-reversed twiddle order (ref: src/ntt.c:37-52)."""
    n = a.shape[-1]
    dim = a.shape[-2]
    batch = tuple(a.shape[:-2])
    ones = (1,) * len(batch)
    p = ps.reshape(ones + (dim, 1, 1))
    pv = pinv.reshape(ones + (dim, 1, 1))
    length = n // 2
    while length >= 1:
        nblocks = n // (2 * length)
        x = a.reshape(batch + (dim, nblocks, 2, length))
        z = zetas[:, nblocks:2 * nblocks].reshape(ones + (dim, nblocks, 1))
        x0 = x[..., 0, :]
        x1 = x[..., 1, :]
        t = plain_mont_mul(x1, z, p, pv)
        a = torch.stack([plain_addmod(x0, t, p), plain_submod(x0, t, p)],
                        dim=-2).reshape(batch + (dim, n))
        length //= 2
    return a


def ntt_galois_perm(logn: int, rot: int | None) -> np.ndarray:
    """Index permutation realizing the galois automorphism IN THE NTT DOMAIN.

    The butterfly NTT's output index i holds the evaluation at w^(2*brv(i)+1)
    (w = 2n-th root; Kyber-shaped CT network, ref: src/ntt.c:37-52).  The
    automorphism X -> X^g (g = 5^rot for rotations, ref: src/poly.c:263-276;
    g = -1 for conjugation, ref: src/poly.c:278-283) evaluates the original
    polynomial at w^(e*g), so NTT(galois(a))[j] = NTT(a)[perm[j]] with
    2*brv(perm[j])+1 = (2*brv(j)+1)*g mod 2n — a pure permutation (no signs:
    Montgomery/scale factors are index-independent)."""
    n = 1 << logn
    m = 2 * n
    g = pow(5, rot, m) if rot is not None else m - 1

    def brv(x):
        r = 0
        for _ in range(logn):
            r = (r << 1) | (x & 1)
            x >>= 1
        return r

    e = np.array([2 * brv(j) + 1 for j in range(n)], dtype=np.int64)
    inv_e = np.zeros(m, dtype=np.int64)
    inv_e[e] = np.arange(n)
    return inv_e[(e * g) % m].astype(np.int32)


def intt(a, zetas_inv, ps, pinv, ninv_mont):
    """Inverse NTT, Gentleman-Sande order, with final n^-1 scaling
    (ref: src/ntt.c:54-73).  Pass n^-1 * phat^-1 (Montgomery form) as
    ninv_mont for the scaled inverse of the CRT reconstruct."""
    n = a.shape[-1]
    dim = a.shape[-2]
    batch = tuple(a.shape[:-2])
    ones = (1,) * len(batch)
    p = ps.reshape(ones + (dim, 1, 1))
    pv = pinv.reshape(ones + (dim, 1, 1))
    length = 1
    while length <= n // 2:
        nblocks = n // (2 * length)
        x = a.reshape(batch + (dim, nblocks, 2, length))
        z = zetas_inv[:, nblocks:2 * nblocks].reshape(ones + (dim, nblocks, 1))
        x0 = x[..., 0, :]
        x1 = x[..., 1, :]
        y1 = plain_mont_mul(plain_submod(x0, x1, p), z, p, pv)
        a = torch.stack([plain_addmod(x0, x1, p), y1],
                        dim=-2).reshape(batch + (dim, n))
        length *= 2
    nv = ninv_mont.reshape(ones + (dim, 1))
    return plain_mont_mul(a, nv, ps.reshape(ones + (dim, 1)),
                    pinv.reshape(ones + (dim, 1)))
