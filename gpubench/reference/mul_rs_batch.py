"""Inputs and plaintext circuit of request kind mul_rs_batch: the slot-wise
product m1 * m2 of each pair."""

from __future__ import annotations

import numpy as np

from gpubench.reference import ckks, prec


def inputs(cfg, traffic, rng) -> dict:
    n, slots, pool = 1 << cfg["logn"], cfg["slots"], traffic["pool"]
    return {"s": ckks.secret_key(n, cfg["h"], rng),
            "m1": prec.unit_box(rng, (pool, slots)),
            "m2": prec.unit_box(rng, (pool, slots))}


def circuit(inp, items, cfg, dtype: str, device: str = "cpu") -> np.ndarray:
    c = prec.Cx.of(inp["m1"][items], dtype, device)
    return c.mul(prec.Cx.of(inp["m2"][items], dtype, device)).numpy()
