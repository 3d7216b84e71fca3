"""boot_stage_ms.coeff2slot: the median over the span pass of a bootstrap's
coeff2slot without its SubSum, synchronised, in ms."""

import statistics


def read(r):
    s = r["spans"].get("coeff2slot")
    return 1e3 * statistics.median(s) if s else None
