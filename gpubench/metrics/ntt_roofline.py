"""ntt_roofline: the least time the NTT work of the stretch's requests
needs on the card (work/<traffic work>.py, reckoned from the operation and
the context's sizes), in % of the union time of the device kernels that
devtrace.kernel_module classes as ntt or ntt4."""

from gpubench import harness


def read(r):
    c = r["capture"]
    work = r["traffic"].get("work")
    if c is None or not work or not r["sizes"]:
        return None
    t_ntt = c["union_s"](("ntt", "ntt4"))
    if t_ntt <= 0:
        return None
    need = harness.load_module("work", work).reckon(r["sizes"])["bound_s"] * r["requests"]
    return 100 * need / t_ntt
