"""n16.circuit and what reads it: its configuration against the ring of
ckks-n16-q1751; the mul_chain request kind on a tiny ring of that chain (the CPU twin), judged against the plain
reference; its bfloat16 control; the traffic's levels against the port's
context; the port's LIFT_WIDE counter over one request against the count
the context's bounds give; and the new reader where nothing was traced."""

import os

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.tests import tiny

N16 = harness.load_json(os.path.join(harness.HERE, "configs", "ckks-n16-q1751-circuit.json"))
RING16 = harness.load_json(os.path.join(harness.HERE, "configs", "ckks-n16-q1751.json"))
TRAFFIC = harness.load_json(os.path.join(harness.HERE, "traffic", "mulchain_l40_n16.json"))
BOOT16 = harness.load_json(os.path.join(harness.HERE, "traffic", "bootstrap_l1_n16.json"))
# ckks-n16-q1751's chain at n=2^5, the cell's levels (40 down to 1), a pool
# of 2.  The limit is set from what the port gives there: 3.3e-8 to 8.2e-8
# over six seeds, against 1.3e-2 to 2.1e-2 for the bfloat16 control.
TINY = (dict(tiny.RING9, logn=5, logq=1751, slots=4),
        dict(kind="mul_chain", pool=2, batch=1, level_in=40, level_out=1, message_scale=1.0,
             judged=1, judge_within=1), 1e-6)
SEEDS = (11, 2**31 + 7, 3_000_000_019)


def cell() -> harness.Cell:
    cfg, traffic, limit = TINY
    return harness.Cell("tiny.mul_chain", 1, dict(cfg), {**tiny.COMMON, **traffic},
                        {"max_err": limit}, tiny.E2E, [], "bfloat16")


def context(cfg: dict):
    from gpqhe_tpu_torch.context import HeContext
    return HeContext(logn=cfg["logn"], q=1 << cfg["logq"], slots=cfg["slots"],
                     Delta=1 << cfg["logDelta"], logp=cfg["logp"])


def lift_widths(ctx, l: int) -> list:
    """The limbs a row of each CRT lift of mul_rs at level l has, from the
    context's bounds: the cross terms' reconstruct over dim_mul(l) primes
    (kept to the level's limbs), the key switch's over dim_swk(l) (kept to
    the top level's) and its sub-basis's over the first ctx.dim primes
    (exact).  A reconstruct lifts its basis's whole width where its bound
    leaves under 3 bits below P, else only the limbs it keeps."""
    from gpqhe_tpu_torch.ops import rns
    from gpqhe_tpu_torch.substrate import bigint
    kl, kq = bigint.nlimbs(ctx.q[l].bit_length()), bigint.nlimbs(ctx.q[ctx.L].bit_length())
    out = []
    for dim, bound, keep in ((ctx.dim_mul(l), ctx.bits_mul(l), kl),
                             (ctx.dim_swk(l), ctx.bits_swk(l), kq)):
        plan = rns.make_recon_plan(ctx.poly, dim, "cpu")
        out.append(keep if plan.logP - bound >= 3 else plan.ks)
    return out + [rns.make_recon_plan(ctx.poly, ctx.dim, "cpu").ks]


def wide_lifts(ctx, traffic: dict, above: int) -> list:
    """(level, limbs) of each lift of one request wider than `above` limbs."""
    levels = range(traffic["level_in"], traffic["level_out"], -1)
    return [(l, k) for l in levels for k in lift_widths(ctx, l) if k > above]


def test_a_judged_chain_run_is_correct_against_the_plaintext_circuit():
    """A whole run of the tiny ring on the n16 chain (set-up, warm-up, the
    closed loop, the judgement): every output at level 1, within the limit."""
    r = tiny.run(cell())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["judged_outputs"]["value"] >= 1
    assert r["checks"]["max_err"]["value"] < TINY[2]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_bfloat16_control_fails_on_max_err(seed):
    """The circuit in bfloat16 in the program's place misses on max_err,
    the tiny cell's and n16.circuit's own, with no request failed otherwise
    (a product keeps no level to fail on)."""
    for c in (cell(), harness.Cell.load("n16.circuit")):
        checks = harness.control(c, seed)["checks"]
        assert c.control == "bfloat16"
        assert checks["max_err"]["value"] > 10 * checks["max_err"]["limit"], (c.name, checks)
        assert checks["failed_requests"]["value"] == checks["judged_outputs"]["value"]


def test_the_configuration_is_the_bootstrappable_ring():
    """ckks-n16-q1751-circuit runs on ckks-n16-q1751's ring unchanged: the
    same ring, chain, key-switching primes and secret, so its levels are
    the levels n16.bootstrap returns; only the work and what the card
    holds differ, and no bootstrap is in its request."""
    ring = ("logn", "logq", "slots", "logDelta", "logp", "h", "ntt_impl", "levels")
    assert {k: N16[k] for k in ring} == {k: RING16[k] for k in ring}
    assert N16["reduced"] == [] and "bootstrap_iter" not in N16
    assert N16["source"] != RING16["source"] and N16["name"] != RING16["name"]


def test_the_traffics_levels_are_the_contexts():
    """The chain starts at the level n16.bootstrap returns at (its
    min_level, 40 of 58) and ends at the level it takes (1): 39 products,
    each with a second operand of its own."""
    ctx = context(N16)
    assert ctx.L == N16["levels"] == 58
    assert TRAFFIC["level_in"] == BOOT16["min_level"] == 40
    assert TRAFFIC["level_out"] == BOOT16["level_in"] == 1
    c = harness.Cell.load("n16.circuit")
    assert c.cfg == N16 and c.traffic == TRAFFIC
    inputs = c.reference.inputs(c.cfg, c.traffic, np.random.default_rng(3))
    assert inputs["w"].shape == (39, N16["slots"]) and inputs["x"].shape == (8, N16["slots"])
    assert np.allclose(np.abs(inputs["w"]), 1.0)
    assert np.all(np.abs(inputs["x"].real) <= 1.0) and np.all(np.abs(inputs["x"].imag) <= 1.0)
    assert c.kind.levels(c.traffic) == list(range(40, 1, -1))


def test_one_wide_lift_a_request_at_n16():
    """On ckks-n16-q1751 the key switch at level 37 is the one reconstruct
    of the chain whose bound leaves under 3 bits below P (2 bits at 79
    primes): its exact lift of 147 limbs is the request's one lift past 128
    limbs, what lift_wide_per_req.n16 reads on the card."""
    from gpqhe_tpu_torch.ops import rns
    ctx = context(N16)
    assert ctx.dim_swk(37) == 79
    assert wide_lifts(ctx, TRAFFIC, rns.WIDE_LIMBS) == [(37, 147)]


@pytest.fixture(scope="module")
def traced_request():
    """The tiny cell's set-up and one op-traced request on the CPU twin."""
    from gpqhe_tpu_torch.utils import trace
    c = cell()
    inputs = c.reference.inputs(c.cfg, c.traffic, np.random.default_rng(5))
    st = c.kind.setup(c.cfg, c.traffic, inputs, 5, torch.device("cpu"))
    return c, st, trace


@pytest.mark.parametrize("above", [None, 56, 40])
def test_the_wide_lift_counter_counts_the_contexts_lifts(traced_request, monkeypatch, above):
    """LIFT_WIDE over one request equals the count of the context's lifts
    past WIDE_LIMBS (none on this ring: its margins are 3 bits or more) and,
    with the threshold lowered to 56 and 40 limbs, past those (the key
    switches' sub-basis lifts of 57 limbs, and wider), so the count is held
    to the lifts the request makes."""
    from gpqhe_tpu_torch.ops import rns
    c, st, trace = traced_request
    if above is not None:
        monkeypatch.setattr(rns, "WIDE_LIMBS", above)
    want = wide_lifts(context(c.cfg), c.traffic, rns.WIDE_LIMBS)
    with trace.op_trace() as t:
        out = c.kind.call(st, 0)[0]
    assert out.l == c.traffic["level_out"]
    assert t.counter(rns.LIFT_WIDE).get("calls", 0) == len(want)
    assert (want == []) == (above is None)
    read = harness.load_module("metrics", "lift_wide_per_req.n16").read
    assert read({"capture": None, "requests": 1}) == len(want)


def test_the_wide_lift_reader_reads_nothing_where_nothing_was_traced(monkeypatch):
    """None where nothing was op-traced, and on a port without LIFT_WIDE
    (the parent's)."""
    from gpqhe_tpu_torch.ops import rns
    from gpubench import programtrace
    read = harness.load_module("metrics", "lift_wide_per_req.n16").read
    monkeypatch.setattr(programtrace, "last", lambda: None)
    assert read({"capture": None, "requests": 1}) is None
    monkeypatch.undo()
    monkeypatch.setattr(programtrace, "last", lambda: object())
    monkeypatch.delattr(rns, "LIFT_WIDE")
    assert read({"capture": None, "requests": 1}) is None
