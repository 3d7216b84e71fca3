"""bootstrap_dev_ms.coeff2slot: device milliseconds (CUDA events) of one
bootstrap's coeff2slot without the SubSum it holds, the port's
bootstrap.coeff2slot less bootstrap.subsum spans of the op-traced request."""

from gpubench import programtrace


def read(r):
    c2s = programtrace.span_ms("bootstrap.coeff2slot", "device")
    sub = programtrace.span_ms("bootstrap.subsum", "device")
    return None if c2s is None or sub is None else c2s - sub
