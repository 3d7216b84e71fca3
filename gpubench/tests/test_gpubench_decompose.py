"""What reads the RNS decomposes: the port's DECOMP counter over a request
of the tiny mul_rs_batch cell (the CPU twin) against a hand count,
work/decompose.py's bytes against a hand count at the n16 cell's shapes,
and the decompose metric's reader where nothing was traced."""

import numpy as np
import pytest
import torch

from gpubench import harness, peaks
from gpubench.tests import tiny
from gpubench.work import decompose


def test_the_decompose_counter_counts_a_requests_decomposes():
    """DECOMP over one mul_rs_batch request on the CPU twin: every decompose
    and the words read and written, as counted around plain_decompose_core
    (which the signed form calls once too); no tensor-core route on the
    CPU."""
    from gpqhe_tpu_torch.ops import rns
    from gpqhe_tpu_torch.utils import trace
    c = tiny.cell("mul_rs_batch")
    inputs = c.reference.inputs(c.cfg, c.traffic, np.random.default_rng(3))
    st = c.kind.setup(c.cfg, c.traffic, inputs, 3, torch.device("cpu"))
    seen = []
    real = rns.plain_decompose_core

    def counted(a, ps, pinv, weights):
        k = a.shape[-1]
        seen.append((a.numel() // k, k, weights.shape[0]))
        return real(a, ps, pinv, weights)
    rns.plain_decompose_core = counted
    try:
        with trace.op_trace() as t:
            c.kind.call(st, 0)
    finally:
        rns.plain_decompose_core = real
    got = t.counter(rns.DECOMP)
    assert got["calls"] == len(seen) > 0
    assert got["rows"] == sum(r for r, _, _ in seen)
    assert got["limb_words"] == sum(r * k for r, k, _ in seen)
    assert got["residue_words"] == sum(r * d for r, _, d in seen)
    assert got.get("tc_calls", 0) == 0            # nonzero keys only


def test_decompose_bytes_by_hand():
    """The n16 product's decompose: 2^16 rows of 55 int64 limbs in, 60
    int64 residues a row out; 18.0 us at 3.35 TB/s."""
    rows = 1 << 16
    w = decompose.reckon({"calls": 1, "tc_calls": 1, "rows": rows, "limb_words": rows * 55,
                          "residue_words": rows * 60})
    assert w["bytes"] == 8 * rows * (55 + 60) == 60_293_120
    assert w["bound_s"] == pytest.approx(60_293_120 / peaks.PEAK_BYTES_S)
    assert w["bound_s"] == pytest.approx(18.0e-6, rel=1e-3)
    assert decompose.reckon({})["bytes"] == 0


def test_the_decompose_reader_reads_nothing_where_nothing_was_traced(monkeypatch):
    from gpubench import programtrace
    read = harness.load_module("metrics", "decompose_roofline.n16").read
    monkeypatch.setattr(programtrace, "last", lambda: None)
    assert read({"capture": None, "requests": 3}) is None
    assert read({"capture": {"union_s": lambda mods: 1e-3}, "requests": 3}) is None
