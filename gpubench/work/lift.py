"""The bytes the CRT lifts of one request move, reckoned from the lifts'
operands as the port counts them (gpqhe_tpu_torch/ops/rns.py LIFT: rows,
digit_words, limb_words), never from the kernel that ran them: the same
whichever kernel, chunking or fusion implements the lift.

A lift turns each row's digit sums (f64 or int64: 8 bytes each) and its f64
estimate of S / P into the row's limbs (int64: 8 bytes each): each read once
and written once.  Its constant tables (P, P/2, M - P and the digits of
2^(16 ds) - P: a few KB a basis, L1-resident) are not counted, nor any
multiply: the lift's arithmetic is adds, ballots and shuffles.  The least
time is the bytes over the memory peak (peaks.py).
"""

from __future__ import annotations

from gpubench import peaks


def reckon(counts: dict) -> dict:
    """Bytes and the least seconds of the lifts counted in `counts` (the
    LIFT counter's change over a stretch; absent keys count 0)."""
    words = sum(counts.get(k, 0) for k in ("digit_words", "rows", "limb_words"))
    nbytes = 8 * words
    return {"bytes": nbytes, "bound_s": nbytes / peaks.PEAK_BYTES_S, "bound_by": "bytes"}
