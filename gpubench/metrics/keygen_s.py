"""keygen_s: host seconds of set-up in switch-key generation (CKKS.genswk:
relinearization, conjugation and rotation keys) outside programs' first
calls, the port's set-up total."""

from gpubench import programtrace


def read(r):
    return programtrace.setup("keygen_s")
