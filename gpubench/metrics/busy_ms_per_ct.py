"""busy_ms_per_ct: the union of device-operation intervals over a profiled
stretch, in ms, per output ciphertext of the stretch."""


def read(r):
    c = r["capture"]
    return None if c is None else 1e3 * c["busy_s"] / r["outputs"]
