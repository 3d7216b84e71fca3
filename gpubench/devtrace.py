"""From a torch.profiler capture to the numbers the per-layer metrics read.

- busy time is the UNION of the device operations' intervals, never their
  sum: kernels launched with programmatic stream serialization overlap their
  predecessors in the trace, and a sum then counts the overlap twice (a
  graphed coeff2slot read 35.5 ms busy against a 33.7 ms wall that way);
- a capture sometimes loses device events: `events_complete` holds the
  hand-written kernels a capture saw against the launches the program's
  counters (ops/*_cuda.py LAUNCHES, which a graph's replay adds to again)
  say it made, and a capture that fails it is taken again or not read;
- `kernel_module` and `host_dispatches` are copied from the repository's
  chip_smoke.py, where they were sound.
"""

from __future__ import annotations

import re

# the port's launch counters by the module a device kernel's name puts it in
COUNTED = {"ntt": (("ntt_cuda", "LAUNCHES"), ("ntt_cuda32", "LAUNCHES32")),
           "ntt4": (("ntt4_cuda", "LAUNCHES"),),
           "modmath": (("modmath_cuda", "LAUNCHES"),),
           "limbs": (("limbs_cuda", "LAUNCHES"),),
           "rns decompose": (("rns_cuda", "LAUNCHES", "decompose"),),
           "rns digit_split": (("rns_cuda", "LAUNCHES", "digit_split"),),
           "rns lift": (("rns_cuda", "LAUNCHES", "lift"),)}


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))


def clipped(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def kernel_module(name: str) -> str:
    """The module whose kernel a device operation's name is: ntt (csrc/ntt.cu,
    ntt32.cu), ntt4 (the four-step stage, csrc/ntt4.cu), modmath, "rns
    <entry>" (decompose, digit_split or lift) or limbs (the elementwise
    kernels, named by their prefix), "matmul" (torch's matrix products),
    "copies" (the device's copies and fills: a graph's static inputs and the
    clones of its outputs), else "other torch"."""
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if re.search(r"(?<![A-Za-z_])ntt_(col|row)_pass", name):
        return "ntt"
    if re.search(r"(?<![A-Za-z_])ntt4_stage_kernel", name):
        return "ntt4"
    m = re.search(r"(?<![A-Za-z_])rns_(decompose|digit_split|lift)_kernel", name)
    if m:
        return f"rns {m.group(1)}"
    m = re.search(r"(?<![A-Za-z_])(mm|limbs)_[a-z_]*kernel", name)
    if m:
        return {"mm": "modmath", "limbs": "limbs"}[m.group(1)]
    if re.search(r"gemm|gemv|matmul", name, flags=re.I):
        return "matmul"
    return "other torch"


def host_dispatches(names) -> dict:
    """The host's calls that put work on the device, from the names of a
    profile's CUDA runtime events: graph launches, copies (and fills),
    kernel launches."""
    out = {"graph_launches": 0, "copies": 0, "kernel_launches": 0}
    for name in names:
        if name.startswith(("cudaGraphLaunch", "cuGraphLaunch")):
            out["graph_launches"] += 1
        elif name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")):
            out["copies"] += 1
        elif name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            out["kernel_launches"] += 1
    return out


def events_complete(kernels_by_module: dict, launched: dict) -> tuple[bool, dict]:
    """Whether a capture kept every hand-written kernel: for each module the
    counters say launched C > 0 times, the capture must hold a whole
    multiple k C of its kernels, k >= 1 (an entry launches a fixed number
    of kernels).  Returns (complete, {module: [seen, launched]})."""
    seen = {m: [kernels_by_module.get(m, 0), c] for m, c in launched.items() if c > 0}
    ok = bool(seen) and all(h >= c and h % c == 0 for h, c in seen.values())
    return ok, seen


def reduce_capture(events, window: tuple[float, float]) -> dict:
    """The numbers one capture gives over window = (start, end) in the
    profiler's microseconds: device busy (the union), busy by module (each
    module's union), device operation counts by module, the longest idle
    gaps named by the innermost host range around them, and the host's
    dispatches.  events: (name, kind, start_us, end_us) with kind "device"
    or "host"."""
    lo, hi = window
    device = [(n, a, b) for n, k, a, b in events if k == "device" and b > lo and a < hi]
    host = [(n, a, b) for n, k, a, b in events if k == "host"]
    busy = merged(clipped([(a, b) for _, a, b in device], lo, hi))
    by_module: dict[str, list] = {}
    counts: dict[str, int] = {}
    for n, a, b in device:
        m = kernel_module(n)
        by_module.setdefault(m, []).append((a, b))
        counts[m] = counts.get(m, 0) + 1
    gaps = []
    prev = lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) / 2
        around = [(b - a, n) for n, a, b in host if a <= mid <= b]
        named.append([min(around)[1] if around else "no host range", (g1 - g0) * 1e-6])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (hi - lo) * 1e-6,
            "module_s": {m: union_length(clipped(iv, lo, hi)) * 1e-6
                         for m, iv in by_module.items()},
            "union_s": lambda mods: union_length(clipped(
                [iv for m in mods for iv in by_module.get(m, [])], lo, hi)) * 1e-6,
            "device_ops": counts,
            "idle_gaps": named,
            "dispatches": host_dispatches(n for n, _, _ in host)}
