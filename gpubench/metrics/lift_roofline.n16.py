"""lift_roofline.n16: the least time the CRT lifts of one request need on the
card (their bytes, work/lift.py, from the port's LIFT counter over the
op-traced request), in % of the union time per request of the device
kernels that devtrace.kernel_module classes as the lift ("rns lift") over
the profiled stretch.  None where the port has no such counter (an older
port) or made no lift."""

from gpubench import harness, programtrace


def counts():
    """The LIFT counter's change over the last op-trace block, or None."""
    t = programtrace.last()
    if t is None:
        return None
    from gpqhe_tpu_torch.ops import rns
    lift = getattr(rns, "LIFT", None)
    return None if lift is None else t.counter(lift)


def read(r):
    c = r["capture"]
    n = counts()
    if c is None or not n or not n.get("digit_words"):
        return None
    t_lift = c["union_s"](("rns lift",)) / r["requests"]
    if t_lift <= 0:
        return None
    return 100 * harness.load_module("work", "lift").reckon(n)["bound_s"] / t_lift
