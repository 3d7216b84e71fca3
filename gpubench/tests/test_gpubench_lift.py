"""ckks-n16-q1751 and what reads its lifts: the configuration's sizes from
the port's context, the level its bootstrap returns at (the n16 traffic's
min_level) and the port's LIFT counter over a bootstrap on the chain's tiny
ring (the CPU twin), work/lift.py's bytes against a hand count, and the
lift metric's reader where nothing was traced."""

import os

import numpy as np
import pytest
import torch

from gpubench import harness, peaks
from gpubench.tests import tiny
from gpubench.work import lift

N16 = harness.load_json(os.path.join(harness.HERE, "configs", "ckks-n16-q1751.json"))
TRAFFIC16 = harness.load_json(os.path.join(harness.HERE, "traffic", "bootstrap_l1_n16.json"))
# ckks-n16-q1751's chain at n=2^5: L = 58, q_1 = 2^41, a key switch at up to
# 90 primes; slots, iter and min_level as the cell's.  The limit is set from
# what the port gives there: 1.8e-3 to 4.7e-3 over six seeds.
TINY16 = (dict(tiny.RING9, logn=5, logq=1751, slots=4, bootstrap_iter=9),
          dict(kind="bootstrap", pool=2, batch=1, level_in=1, min_level=40, message_scale=0.1,
               judged=1, judge_within=1), 2e-2)


def cell16() -> harness.Cell:
    cfg, traffic, limit = TINY16
    return harness.Cell("tiny.bootstrap_q1751", 1, dict(cfg), {**tiny.COMMON, **traffic},
                        {"max_err": limit}, tiny.E2E, [])


def test_a_run_on_the_chain_is_correct_against_the_plaintext_circuit():
    """A whole run of the tiny ring on the n16 chain (set-up, warm-up, the
    closed loop, the judgement): every output within the limit and at
    min_level or above."""
    r = tiny.run(cell16())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["judged_outputs"]["value"] >= 1
    assert r["checks"]["max_err"]["value"] < TINY16[2]


def test_the_configs_sizes_are_the_contexts():
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.substrate import bigint
    c = N16
    ctx = HeContext(logn=c["logn"], q=1 << c["logq"], slots=c["slots"],
                    Delta=1 << c["logDelta"], logp=c["logp"])
    assert ctx.L == c["levels"] == 58 and ctx.poly.n == 1 << 16
    assert (ctx.dim, ctx.dim_mul(ctx.L), ctx.dimswk) == (30, 60, 90)
    assert bigint.nlimbs(ctx.q[ctx.L].bit_length()) == 55
    # q_0 = 2^11 and q_1 = 2^41, the bottom of the n15 chain's ladder
    assert (tiny.ckks.level_bits(c, 0), tiny.ckks.level_bits(c, 1)) == (11, 41)


def _bootstrap_once():
    """One request of the tiny ring on the n16 chain, its setup and the
    lifts the CPU twin made, counted by hand around plain_lift."""
    from gpqhe_tpu_torch.ops import rns
    from gpqhe_tpu_torch.utils import trace
    c = cell16()
    inputs = c.reference.inputs(c.cfg, c.traffic, np.random.default_rng(5))
    st = c.kind.setup(c.cfg, c.traffic, inputs, 5, torch.device("cpu"))
    seen = []
    real = rns.plain_lift

    def counted(s_digits, af, plan, center, k_out):
        seen.append((af.numel(), plan.ks if k_out is None else k_out, s_digits.shape[-1]))
        return real(s_digits, af, plan, center, k_out)
    rns.plain_lift = counted
    try:
        with trace.op_trace() as t:
            out = c.kind.call(st, 0)[0]
    finally:
        rns.plain_lift = real
    return c, out, t.counter(rns.LIFT), seen


@pytest.fixture(scope="module")
def boot():
    return _bootstrap_once()


def test_the_bootstrap_returns_at_the_traffics_min_level(boot):
    """The pipeline (SubSum, coeff2slot, EvalSin at iter 9, slot2coeff)
    spends 18 levels of 58 at slots 4: the n16 cell's min_level."""
    c, out, _, _ = boot
    assert (c.cfg["logq"], c.cfg["slots"], c.cfg["bootstrap_iter"]) == (
        N16["logq"], N16["slots"], N16["bootstrap_iter"])
    assert out.l == TRAFFIC16["min_level"] == c.traffic["min_level"] == 40


def test_the_lift_counter_counts_the_bootstraps_lifts(boot):
    """LIFT over one bootstrap on the CPU twin: every lift and the words
    read and written, as counted around plain_lift.  No lift passes 128
    limbs: a key switch lifts its 55-limb fast path wherever the bound leaves
    3 bits of margin in P, and its exact lifts have 57 limbs."""
    _, _, got, seen = boot
    assert got["calls"] == len(seen) > 100
    assert got["rows"] == sum(r for r, _, _ in seen)
    assert got["limb_words"] == sum(r * k for r, k, _ in seen)
    assert got["digit_words"] == sum(r * min(kd, 2 * k) for r, k, kd in seen)
    assert max(k for _, k, _ in seen) == 57


@pytest.mark.parametrize("k_out", [None, 55])
def test_the_lift_counter_counts_a_key_switchs_reconstruct(k_out):
    """The key switch's reconstruct at the chain's 90 primes: the exact path
    lifts 167 limbs, the fast path the ciphertext's 55."""
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ops import rns
    from gpqhe_tpu_torch.utils import trace
    ring = PolyContext(5, q=1 << 20, dim_cap=90)
    ba, plan = rns.make_basis_arrays(ring, 90, "cpu"), rns.make_recon_plan(ring, 90, "cpu")
    assert plan.ks == 167
    ps = np.array(ring.primes[:90], dtype=np.uint64)[:, None]
    res = np.random.default_rng(90).integers(0, 1 << 63, (90, 32), dtype=np.uint64) % ps
    with trace.op_trace() as t:
        out = rns.reconstruct(torch.from_numpy(res.view(np.int64)), ba, plan, k_out=k_out,
                              bound_bits=None if k_out is None else plan.logP - 3)
    k = k_out or 167
    assert out.shape == (32, k)
    assert t.counter(rns.LIFT) == {"calls": 1, "rows": 32, "digit_words": 32 * 2 * k,
                                   "limb_words": 32 * k}


def test_lift_bytes_by_hand():
    """One exact lift of the n16 key switch at 90 primes: 2^16 rows of 334
    f64 digit sums and an f64 estimate in, 167 int64 limbs out."""
    rows = 1 << 16
    w = lift.reckon({"calls": 1, "rows": rows, "digit_words": rows * 334,
                     "limb_words": rows * 167})
    assert w["bytes"] == 8 * rows * (334 + 1 + 167) == 263_192_576
    assert w["bound_s"] == pytest.approx(263_192_576 / peaks.PEAK_BYTES_S)
    assert w["bound_s"] == pytest.approx(78.57e-6, rel=1e-3)
    assert lift.reckon({})["bytes"] == 0


def test_the_lift_reader_reads_nothing_where_nothing_was_traced(monkeypatch):
    from gpubench import programtrace
    read = harness.load_module("metrics", "lift_roofline.n16").read
    monkeypatch.setattr(programtrace, "last", lambda: None)
    assert read({"capture": None, "requests": 3}) is None
    assert read({"capture": {"union_s": lambda mods: 1e-3}, "requests": 3}) is None
