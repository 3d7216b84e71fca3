"""bootstrap_dev_ms.evalsin: device milliseconds (CUDA events) of both
mod-reduce (EvalSin) stages of one bootstrap, the port's bootstrap.evalsin
spans of the op-traced request; no synchronise inside."""

from gpubench import programtrace


def read(r):
    return programtrace.span_ms("bootstrap.evalsin", "device")
