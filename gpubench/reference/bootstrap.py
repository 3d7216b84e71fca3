"""Inputs and plaintext circuit of request kind bootstrap: the identity (a
bootstrap refreshes the levels and keeps the message)."""

from __future__ import annotations

import numpy as np

from gpubench.reference import ckks, prec


def inputs(cfg, traffic, rng) -> dict:
    n, slots, pool = 1 << cfg["logn"], cfg["slots"], traffic["pool"]
    return {"s": ckks.secret_key(n, cfg["h"], rng),
            "m": prec.unit_box(rng, (pool, slots), traffic["message_scale"])}


def circuit(inp, items, cfg, dtype: str, device: str = "cpu") -> np.ndarray:
    return prec.Cx.of(inp["m"][items], dtype, device).numpy()
