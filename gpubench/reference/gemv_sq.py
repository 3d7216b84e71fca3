"""Inputs and plaintext circuit of request kind gemv_sq: (A v)^2 + b, slot
by slot, A a real slots x slots matrix, v a pool item, b the bias."""

from __future__ import annotations

import numpy as np

from gpubench.reference import ckks, prec


def inputs(cfg, traffic, rng) -> dict:
    n, slots, pool = 1 << cfg["logn"], cfg["slots"], traffic["pool"]
    return {"s": ckks.secret_key(n, cfg["h"], rng),
            "A": rng.uniform(-0.25, 0.25, (slots, slots)),
            "v": prec.unit_box(rng, (pool, slots)),
            "b": prec.unit_box(rng, slots)}


def circuit(inp, items, cfg, dtype: str, device: str = "cpu") -> np.ndarray:
    y = prec.Cx.of(inp["v"][items], dtype, device).matvec(prec.Cx.of(inp["A"], dtype, device))
    return y.mul(y).add(prec.Cx.of(inp["b"], dtype, device)).numpy()
