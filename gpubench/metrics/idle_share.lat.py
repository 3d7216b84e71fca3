"""idle_share.lat: the device's idle share over a profiled stretch of whole
requests, 1 - (union of device-operation intervals) / wall; None where the
capture lost device events."""


def read(r):
    c = r["capture"]
    return None if c is None else 1 - c["busy_s"] / c["window_s"]
