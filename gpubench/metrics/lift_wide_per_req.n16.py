"""lift_wide_per_req.n16: the CRT lifts of one request whose rows have more
than 128 limbs (on a card, the lift at five and six chunks of 32 limbs), the
port's LIFT_WIDE counter over the op-traced request.  None where the port
has no such counter (an older port) or nothing was op-traced."""

from gpubench import programtrace


def read(r):
    t = programtrace.last()
    if t is None:
        return None
    from gpqhe_tpu_torch.ops import rns
    wide = getattr(rns, "LIFT_WIDE", None)
    return None if wide is None else t.counter(wide).get("calls", 0)
