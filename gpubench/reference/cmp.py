"""Inputs and plaintext circuit of request kind cmp: the approximate
comparison a > b of Cheon et al. that the GPQHE reference defines
(src/he-algo.c:460-530), evaluated in plain arithmetic: x = a / (a + b) by
a Goldschmidt inverse of `iter` steps, then t = floor(log2(alpha /
log2(1 + 2^-alpha))) rounds of x <- x^2 / (x^2 + (1 - x)^2), each inverse
again by Goldschmidt.  a and b are real, in [0.1, 1)."""

from __future__ import annotations

import math

import numpy as np

from gpubench.reference import ckks, prec


def inputs(cfg, traffic, rng) -> dict:
    n, slots, pool = 1 << cfg["logn"], cfg["slots"], traffic["pool"]
    return {"s": ckks.secret_key(n, cfg["h"], rng),
            "a": rng.uniform(0.1, 1.0, (pool, slots)) + 0j,
            "b": rng.uniform(0.1, 1.0, (pool, slots)) + 0j}


def rounds(alpha: int) -> int:
    return int(math.log2(alpha / math.log2(1 + 2.0 ** (-alpha))))


def inverse(x: prec.Cx, iters: int) -> prec.Cx:
    """Goldschmidt: 1/x ~ (2 - x) prod_k (1 + (1 - x)^(2^k))."""
    an, bn = x.neg().add_real(2.0), x.neg().add_real(1.0)
    for _ in range(iters):
        bn = bn.mul(bn)
        an = an.mul(bn.add_real(1.0))
    return an


def circuit(inp, items, cfg, dtype: str, device: str = "cpu") -> np.ndarray:
    it = cfg["cmp_iter"]
    a = prec.Cx.of(inp["a"][items], dtype, device)
    b = prec.Cx.of(inp["b"][items], dtype, device)
    inv = inverse(a.add(b).scale(0.5), it)
    an = a.scale(0.5).mul(inv)
    bn = an.neg().add_real(1.0)
    for _ in range(rounds(cfg["cmp_alpha"])):
        an, bn = an.mul(an), bn.mul(bn)
        an = an.mul(inverse(an.add(bn), it))
        bn = an.neg().add_real(1.0)
    return an.numpy()
