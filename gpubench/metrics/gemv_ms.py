"""gemv_ms: the median of the benchmark's synchronised spans around
algo.linalg.gemv_hoisted_full, in ms."""

import statistics


def read(r):
    s = r["spans"].get("gemv")
    return 1e3 * statistics.median(s) if s else None
