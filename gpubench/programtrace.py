"""What the port records about itself (gpqhe_tpu_torch/utils/trace.py), for
the metrics that read it: the spans and counters of the last op-trace block
(the traced run's op-trace pass, one request) and the process's set-up
totals.  Each reader gives None where the port records nothing of it."""

from __future__ import annotations


def _trace():
    from gpqhe_tpu_torch.utils import trace
    return trace


def last():
    """The port's last op-trace block, or None."""
    read = getattr(_trace(), "last", None)
    return None if read is None else read()


def span_ms(name: str, clock: str) -> float | None:
    """Milliseconds summed over the last block's spans called `name`, or,
    where it ends in '.', over those whose names start with it; clock is
    "host" (perf_counter) or "device" (CUDA events).  None where the block
    holds no such span or one lacks the clock's time."""
    t = last()
    if t is None:
        return None
    i = {"host": 0, "device": 1}[clock]
    recs = [r for n, rs in t.spans.items()
            if (n.startswith(name) if name.endswith(".") else n == name) for r in rs]
    if not recs or any(r[i] is None for r in recs):
        return None
    return 1e3 * sum(r[i] for r in recs)


def h2d_bytes() -> int | None:
    """Bytes the last block copied from host limbs to the device."""
    t, h2d = last(), getattr(_trace(), "H2D", None)
    return None if t is None or h2d is None else t.counter(h2d).get("bytes", 0)


def setup(key: str) -> float | None:
    """One of the port's set-up totals since the process started."""
    totals = getattr(_trace(), "SETUP", None)
    return None if totals is None else totals.get(key)
