#!/usr/bin/env python3
"""Device time of the port's CUDA decompose (gpqhe_tpu_torch/csrc/rns.cu)
against the limbs K, the rows n and the primes dim, on one GPU.

Run from the repository root on a machine with an H100:
    python3 tools/rns_decompose_scale.py

Prints one line a shape, "n=... dim=... K=... <µs a launch>" (device time
as chip_smoke.py measures it: calls enqueued behind a sleep, the same
L2-warm tensors every call), a four-slab batch at K=14 for each (n, dim),
and one torch add of a single word, the launch floor, on the same card.
The slope in K is the sums' cost a limb, the intercept the block's fixed
cost (PERF.md §6).
"""
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np
import torch

import chip_smoke as cs
from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import rns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("rns_decompose_scale: needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    pctx = PolyContext(15, 1 << 881)
    out = {}
    for n in (1 << 13, 1 << 14, 1 << 15, 1 << 16):
        for dim in (16, 31, 47):
            ba = rns.make_basis_arrays(pctx, dim, dev)
            for K in (4, 7, 14, 28, 56):
                w = torch.from_numpy(rns.make_decomp_weights(pctx, dim, K).view(np.int64)).to(dev)
                a = cs.ew_limbs(rng, (n, K), dev)
                out[f"n={n} dim={dim} K={K}"] = cs.median(cs.device_ms_runs(
                    lambda: rns.decompose_core(a, ba.ps, ba.pinv, w), 5)) * 1e3
            a = cs.ew_limbs(rng, (4, n, 14), dev)
            w = torch.from_numpy(rns.make_decomp_weights(pctx, dim, 14).view(np.int64)).to(dev)
            out[f"S=4 n={n} dim={dim} K=14"] = cs.median(cs.device_ms_runs(
                lambda: rns.decompose_core(a, ba.ps, ba.pinv, w), 5)) * 1e3
    y = torch.zeros(1, dtype=torch.int64, device=dev)
    out["torch add one word"] = cs.median(cs.device_ms_runs(lambda: y + 1, 5)) * 1e3
    for k, v in out.items():
        print(k, round(v, 2))
    print(cs.gpu_line())


if __name__ == "__main__":
    main()
