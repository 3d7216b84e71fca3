"""capture_s: host seconds of set-up in engine programs' first calls (the
eager warm-up and the CUDA graph capture of each program and shape), the
port's set-up total."""

from gpubench import programtrace


def read(r):
    return programtrace.setup("capture_s")
