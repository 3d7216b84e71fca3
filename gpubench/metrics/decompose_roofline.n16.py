"""decompose_roofline.n16: the least time the RNS decomposes of one request
need on the card (their bytes, work/decompose.py, from the port's DECOMP
counter over the op-traced request), in % of the union time per request of
the device kernels that devtrace.kernel_module classes as decompose ("rns
decompose", both routes) over the profiled stretch.  None where the port
has no such counter (an older port) or made no decompose."""

from gpubench import harness, programtrace


def counts():
    """The DECOMP counter's change over the last op-trace block, or None."""
    t = programtrace.last()
    if t is None:
        return None
    from gpqhe_tpu_torch.ops import rns
    decomp = getattr(rns, "DECOMP", None)
    return None if decomp is None else t.counter(decomp)


def read(r):
    c = r["capture"]
    n = counts()
    if c is None or not n or not n.get("limb_words"):
        return None
    t_dec = c["union_s"](("rns decompose",)) / r["requests"]
    if t_dec <= 0:
        return None
    return 100 * harness.load_module("work", "decompose").reckon(n)["bound_s"] / t_dec
