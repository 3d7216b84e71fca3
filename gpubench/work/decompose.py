"""The bytes the RNS decomposes of one request move, reckoned from their
operands as the port counts them (gpqhe_tpu_torch/ops/rns.py DECOMP: rows,
limb_words, residue_words), never from the kernel that ran them: the same
whichever route (the integer units or the tensor cores), tiling or fusion
implements the decompose.

A decompose turns each row's limbs (int64: 8 bytes each) into the row's
residues (int64: 8 bytes each): each read once and written once.  A signed
row's sign bit is one of its limbs, not counted again.  Its constants (the
weights or the byte table of 2^(8 j) R mod p, a few hundred KB a basis,
L2-resident) are not counted, nor any multiply: the bound is the bytes over
the memory peak (peaks.py).
"""

from __future__ import annotations

from gpubench import peaks


def reckon(counts: dict) -> dict:
    """Bytes and the least seconds of the decomposes counted in `counts`
    (the DECOMP counter's change over a stretch; absent keys count 0)."""
    nbytes = 8 * (counts.get("limb_words", 0) + counts.get("residue_words", 0))
    return {"bytes": nbytes, "bound_s": nbytes / peaks.PEAK_BYTES_S, "bound_by": "bytes"}
