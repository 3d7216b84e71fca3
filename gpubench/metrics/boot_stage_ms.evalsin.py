"""boot_stage_ms.evalsin: the median over the span pass of both mod-reduce
(EvalSin) stages of a bootstrap, synchronised, in ms."""

import statistics


def read(r):
    s = r["spans"].get("evalsin")
    return 1e3 * statistics.median(s) if s else None
