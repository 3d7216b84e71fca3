"""encode_host_ms.n15: host milliseconds of one bootstrap spent building
plaintext limbs, the port's ckks.ecd and ckks.const_pt spans of the
op-traced request (their copies to the card are ckks.h2d, not counted)."""

from gpubench import programtrace


def read(r):
    ms = [programtrace.span_ms(n, "host") for n in ("ckks.ecd", "ckks.const_pt")]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None
