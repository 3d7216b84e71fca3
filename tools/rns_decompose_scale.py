#!/usr/bin/env python3
"""Device time of the port's CUDA decompose (gpqhe_tpu_torch/csrc/rns.cu),
both routes, against the limbs K, the rows n and the primes dim, on one GPU.

Run from the repository root on a machine with an H100:
    python3 tools/rns_decompose_scale.py

Prints one line a shape and route, "n=... dim=... K=... imad|mma <µs a
launch>" (device time as chip_smoke.py measures it: calls enqueued behind a
sleep, the same L2-warm tensors every call; imad the integer units' kernel,
rns_cuda.decompose_imad, mma the tensor cores', decompose_mma), and one
torch add of a single word, the launch floor, on the same card.  The IMAD
route's slope in K is the sums' cost a limb, its intercept the block's fixed
cost; where the two routes cross in K is the dispatcher's K*
(rns_cuda.MMA_MIN_LIMBS, PERF.md section 6).
"""
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np
import torch

import chip_smoke as cs
from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import rns, rns_cuda


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("rns_decompose_scale: needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    pctx = PolyContext(16, q=1 << 20, dim_cap=60)
    out = {}
    for n in (1 << 14, 1 << 15, 1 << 16):
        for dim in (16, 31, 60):
            ba = rns.make_basis_arrays(pctx, dim, dev)
            for K in (8, 12, 14, 16, 20, 24, 28, 40, 56):
                w = torch.from_numpy(rns.make_decomp_weights(pctx, dim, K).view(np.int64)).to(dev)
                a = cs.ew_limbs(rng, (n, K), dev)
                for route, fn in (("imad", rns_cuda.decompose_imad),
                                  ("mma", rns_cuda.decompose_mma)):
                    out[f"n={n} dim={dim} K={K} {route}"] = cs.median(cs.device_ms_runs(
                        lambda: fn(a, ba.ps, ba.pinv, w), 5)) * 1e3
    y = torch.zeros(1, dtype=torch.int64, device=dev)
    out["torch add one word"] = cs.median(cs.device_ms_runs(lambda: y + 1, 5)) * 1e3
    for k, v in out.items():
        print(k, round(v, 2))
    print(cs.gpu_line())


if __name__ == "__main__":
    main()
