"""programs_per_req: the engine programs one request calls, counted by the
port's op trace (gpqhe_tpu_torch/utils/trace.py) in a pass of its own."""


def read(r):
    return sum(r["counts"].values()) if r["counts"] else None
