"""Inputs and plaintext circuit of request kind mul_chain: x times the
second operand w_l of every level the chain multiplies at, x prod_l w_l,
in the order the program takes them (level_in first).  x is in the complex
box of half-width message_scale, each w_l on the unit circle, so that the
product keeps the size of x at every level."""

from __future__ import annotations

import numpy as np

from gpubench.reference import ckks, prec


def inputs(cfg, traffic, rng) -> dict:
    n, slots, pool = 1 << cfg["logn"], cfg["slots"], traffic["pool"]
    products = traffic["level_in"] - traffic["level_out"]
    return {"s": ckks.secret_key(n, cfg["h"], rng),
            "x": prec.unit_box(rng, (pool, slots), traffic["message_scale"]),
            "w": np.exp(1j * rng.uniform(0, 2 * np.pi, (products, slots)))}


def circuit(inp, items, cfg, dtype: str, device: str = "cpu") -> np.ndarray:
    c = prec.Cx.of(inp["x"][items], dtype, device)
    w = prec.Cx.of(inp["w"], dtype, device)
    for k in range(w.re.shape[0]):
        c = c.mul(prec.Cx(w.re[k], w.im[k]))
    return c.numpy()
