"""h2d_mb_per_req.n15: megabytes (1e6 B) of host limbs copied to the card in
one bootstrap, the port's H2D counter over the op-traced request (constant
plaintexts of const_pt and ecd, and raise_modulus's modulus limbs)."""

from gpubench import programtrace


def read(r):
    b = programtrace.h2d_bytes()
    return None if b is None else b / 1e6
