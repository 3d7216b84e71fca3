"""host_dispatches_per_req: graph launches, copies and kernel launches that
the host issued (the capture's CUDA runtime events) per request."""


def read(r):
    c = r["capture"]
    return None if c is None else sum(c["dispatches"].values()) / r["requests"]
