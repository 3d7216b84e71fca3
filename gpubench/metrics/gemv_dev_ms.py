"""gemv_dev_ms: device milliseconds (CUDA events) of one request's hoisted
gemv, the port's linalg.gemv span of the op-traced request; no synchronise
inside."""

from gpubench import programtrace


def read(r):
    return programtrace.span_ms("linalg.gemv", "device")
