"""The NTT work of mul_rs (gpubench/work/mul_rs.py), reckoned from the
context's sizes, and on the card held against what one mul_rs_batch(8)
launches today: a later change to the algorithm shows here as drift."""

import numpy as np
import pytest

from gpubench import harness, peaks
from gpubench.work import mul_rs

N14 = {"n": 1 << 14, "word": 64, "dim_mul": 16, "dim_swk": 24, "batch": 8}


def test_transforms_of_a_batch_of_eight():
    assert mul_rs.transforms(N14) == [("fwd", 32, 16), ("inv", 24, 16), ("fwd", 8, 24),
                                      ("inv", 16, 24)]


def test_reckoned_work_at_logn14_level8():
    w = mul_rs.reckon(N14)
    rows = 512 + 384 + 192 + 384
    assert w["bytes"] == 2 * rows * 16384 * 8 + (24 + 24) * 16384 * 8 == 392_167_424
    assert w["imad"] == 10 * (rows * 8192 * 14 + (384 + 384) * 16384) == 1_814_036_480
    assert w["bound_by"] == "bytes"
    assert w["bound_s"] == pytest.approx(392_167_424 / peaks.PEAK_BYTES_S)
    assert w["bound_s"] == pytest.approx(117.06e-6, rel=1e-3)


def test_work_scales_with_the_batch():
    one = mul_rs.reckon({**N14, "batch": 1})
    eight = mul_rs.reckon(N14)
    tables = 48 * 16384 * 8
    assert eight["bytes"] - tables == 8 * (one["bytes"] - tables)


def test_the_cells_sizes_are_the_contexts():
    from gpqhe_tpu_torch.context import HeContext
    cfg = harness.load_json(harness.os.path.join(harness.HERE, "configs", "ckks-n14-q438.json"))
    ctx = HeContext(logn=cfg["logn"], q=1 << cfg["logq"], slots=cfg["slots"],
                    Delta=1 << cfg["logDelta"], logp=cfg["logp"])
    assert ctx.L == cfg["levels"] == 8
    assert (ctx.poly.n, ctx.dim_mul(ctx.L), ctx.dim_swk(ctx.L)) == (16384, 16, 24)


@pytest.mark.cuda
def test_mul_rs_batch_launches_the_reckoned_transforms(card):
    import torch

    from gpqhe_tpu_torch.ops import ntt_cuda
    from gpqhe_tpu_torch.ring.poly import RingEngine
    from gpqhe_tpu_torch.utils import graphs

    cell = harness.Cell.load("n14.mulrs_b8")
    traffic = {**cell.traffic, "pool": 8}
    inputs = cell.reference.inputs(cell.cfg, traffic, np.random.default_rng(1))
    st = cell.kind.setup(cell.cfg, traffic, inputs, 1, card)
    seen = []
    orig = RingEngine.ntt_f, RingEngine.ntt_i

    def rows(res, dim):
        assert res.shape[-2] == dim
        return int(np.prod(res.shape[:-2])), dim

    def fwd(self, res, dim):
        seen.append(("fwd",) + rows(res, dim))
        return orig[0](self, res, dim)

    def inv(self, res, dim, scale_phatinv=False):
        seen.append(("inv",) + rows(res, dim))
        return orig[1](self, res, dim, scale_phatinv)
    before = sum(ntt_cuda.LAUNCHES.values())
    try:
        RingEngine.ntt_f, RingEngine.ntt_i = fwd, inv
        with graphs.disabled():
            cell.kind.call(st, 0)
        torch.cuda.synchronize()
    finally:
        RingEngine.ntt_f, RingEngine.ntt_i = orig
    assert sum(ntt_cuda.LAUNCHES.values()) - before == len(seen)
    assert sorted(seen) == sorted(mul_rs.transforms(cell.kind.sizes(st)))
