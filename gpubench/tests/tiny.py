"""Cells at rings small enough for a CPU test, one per request kind, with
limits set from what the port gives there (the cells' own limits are for
their own rings)."""

import time

import numpy as np
import torch

from gpubench import harness
from gpubench.reference import ckks

RING9 = dict(logn=9, logq=120, slots=4, logDelta=30, logp=59, h=64, ntt_impl="butterfly")
COMMON = dict(loop="closed", clients=1, warmup=1, trace_requests=2)
TINY = {
    "mul_rs_batch": (RING9, dict(kind="mul_rs_batch", pool=8, batch=4, judged=2, judge_within=2,
                                 work="mul_rs"), 1e-6),
    "gemv_sq": (RING9, dict(kind="gemv_sq", pool=4, batch=1, judged=2, judge_within=2), 1e-6),
    "cmp": (dict(RING9, logn=6, logq=881, cmp_iter=5, cmp_alpha=2),
            dict(kind="cmp", pool=2, batch=1, judged=1, judge_within=1), 1e-6),
    "bootstrap": (dict(RING9, logn=4, logq=610, slots=2, bootstrap_iter=None),
                  dict(kind="bootstrap", pool=2, batch=1, level_in=1, min_level=4,
                       message_scale=0.1, judged=1, judge_within=1), 1e-3),
}
E2E = [{"name": n, "unit": "u"} for n in ("setup_s", "ct_per_s", "latency_p50_ms")]


def cell(kind: str) -> harness.Cell:
    cfg, traffic, limit = TINY[kind]
    return harness.Cell("tiny." + kind, 1, dict(cfg), {**COMMON, **traffic},
                        {"max_err": limit}, E2E, [])


def run(c: harness.Cell, seed: int = 2**31 + 12345, seconds: float = 0.2) -> dict:
    torch.set_num_threads(2)
    return harness.run(c, seed, seconds, False, torch.device("cpu"), time.perf_counter())


def decrypt(ct, s, cfg) -> np.ndarray:
    return ckks.decrypt_decode(harness.host_copy(ct), s, cfg)
