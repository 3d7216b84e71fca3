"""One run of one cell: set-up, warm-up, a closed loop of requests for a
fixed time (or, traced, a profiled stretch and its passes), the judgement
of the outputs against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, request kind or
metric is found by name (README.md):

- gpubench/configs/<config>.json  the deployment's parameters;
- gpubench/traffic/<traffic>.json the mix: request kind, pool, batch, loop,
  warm-up, the traced stretch and the judged sample;
- gpubench/cells/<cell>.json      the limits of the numbers compared;
- gpubench/requests/<kind>.py     set-up and the call the window drives;
- gpubench/reference/<kind>.py    the inputs made from the seed and the
  plaintext circuit;
- gpubench/metrics/<metric>.py    the reader of one per-layer metric;
- gpubench/work/<op>.py           the work a roofline divides by.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import resource
import sys
import time
import warnings
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """gpubench/<folder>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{folder}/{name}.py: no such file under gpubench/")
    spec = importlib.util.spec_from_file_location(f"gpubench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclass
class Cell:
    """A cell as the run needs it: its manifest entry's names, the
    configuration, the traffic mix, the limits and the metrics it reports."""
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    control: str = "float32"

    @classmethod
    def load(cls, name: str, man: dict | None = None) -> "Cell":
        man = manifest() if man is None else man
        wl = {w["name"]: w for w in man["workloads"]}
        if name not in wl:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = wl[name]
        cfgs = {c["name"]: c for c in man["configs"]}
        cfg = load_json(os.path.join(ROOT, cfgs[w["config"]]["file"]))
        traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
        own = load_json(os.path.join(HERE, "cells", name + ".json"))

        def mine(m):
            return "workloads" not in m or name in m["workloads"]
        return cls(name, w["chips"], cfg, traffic, own["limits"],
                   [m for m in man["end_to_end"] if mine(m)],
                   [m for m in man["per_layer"] if mine(m)], own["control"])

    @property
    def kind(self):
        return load_module("requests", self.traffic["kind"])

    @property
    def reference(self):
        return load_module("reference", self.traffic["kind"])


def item_of(traffic: dict, i: int, k: int) -> int:
    """The pool item that output k of request i is computed from."""
    return (i * traffic["batch"] + k) % traffic["pool"]


def judged_requests(traffic: dict, seed: int) -> set[int]:
    """The request indices whose outputs are judged, drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    within = traffic["judge_within"]
    return set(int(i) for i in rng.choice(within, size=min(traffic["judged"], within),
                                          replace=False))


def host_copy(out) -> dict | None:
    """An output ciphertext copied to the host as plain arrays."""
    if out is None:
        return None
    return {"c0": out.c0.cpu().numpy().astype(np.uint32),
            "c1": out.c1.cpu().numpy().astype(np.uint32),
            "l": int(out.l), "nu": float(out.nu)}


class Clock:
    """Per-request latency: CUDA events on a card (the device's clock, from
    the send to the outputs' last operation), the host clock elsewhere."""

    def __init__(self, device):
        import torch
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def start(self):
        if self.cuda:
            self.ev[0].record()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Waits for the device; returns the request's milliseconds."""
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            return self.ev[0].elapsed_time(self.ev[1])
        return (time.perf_counter() - self.t0) * 1e3


def request(kind, state, i: int, clock: Clock):
    """One request of the closed loop: (outputs, ms, why it failed or None)."""
    clock.start()
    try:
        outs = kind.call(state, i)
    except Exception as e:                         # a run error is a failed request
        clock.stop()
        return None, None, f"{type(e).__name__}: {e}"
    ms = clock.stop()
    why = None
    if any(o is None for o in outs):
        why = "no output"
    elif hasattr(kind, "check"):
        why = kind.check(state, outs)
    return outs, ms, why


def window(cell: Cell, kind, state, seconds: float, judged: set[int], device) -> dict:
    """The closed loop of one client for `seconds`: every request's latency,
    the outputs of the judged ones (and of the last) copied to the host."""
    clock = Clock(device)
    lat, kept, bad = [], {}, {}
    i = 0
    outs = None
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        outs, ms, why = request(kind, state, i, clock)
        if ms is not None:
            lat.append(ms)
        if why is not None:
            bad[i] = why
        elif i in judged:
            kept[i] = [host_copy(o) for o in outs]
        i += 1
        if time.perf_counter() >= deadline or len(bad) > 10:
            break
    t1 = time.perf_counter()
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    print(f"gpubench: host cpu s per request, user {(ru1.ru_utime - ru0.ru_utime) / i:.4g}, "
          f"system {(ru1.ru_stime - ru0.ru_stime) / i:.4g}", file=sys.stderr)
    half = len(lat) // 2
    if half:
        print(f"gpubench: latency p50 ms, first half {quantile(lat[:half], 0.5):.4f}, "
              f"second half {quantile(lat[half:], 0.5):.4f}", file=sys.stderr)
    if i - 1 not in kept and i - 1 not in bad and outs is not None:
        kept[i - 1] = [host_copy(o) for o in outs]
    return {"requests": i, "seconds": t1 - t0, "latency_ms": lat, "kept": kept, "bad": bad}


def quantile(values, q: float) -> float:
    """The q-quantile of all values (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 100 * q))


def end_to_end(cell: Cell, loop: dict, setup_s: float, mem_bytes: int) -> dict:
    outputs = loop["requests"] * cell.traffic["batch"]
    lat = loop["latency_ms"]
    values = {"setup_s": setup_s,
              "ct_per_s": outputs / loop["seconds"],
              "latency_p50_ms": quantile(lat, 0.5) if lat else None,
              "latency_p95_ms": quantile(lat, 0.95) if lat else None,
              "device_mem_gb": mem_bytes / 1e9}
    out = {}
    for m in cell.end_to_end:
        v = values.get(m["name"].split(".", 1)[0])     # ct_per_s.n15 is a ct_per_s
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the traced run
# ---------------------------------------------------------------------------

def launched(delta: dict) -> dict:
    """Counted launches by kernel module (devtrace.COUNTED) out of the port's
    counter modules' values before and after."""
    from gpubench import devtrace
    out = {}
    for module, sources in devtrace.COUNTED.items():
        total = 0
        for src in sources:
            d = delta.get(src[0] + "." + src[1], {})
            total += d.get(src[2], 0) if len(src) == 3 else sum(d.values())
        out[module] = total
    return out


def counter_values() -> dict:
    from gpubench import devtrace
    import importlib
    vals = {}
    for sources in devtrace.COUNTED.values():
        for src in sources:
            mod = importlib.import_module("gpqhe_tpu_torch.ops." + src[0])
            vals[src[0] + "." + src[1]] = dict(getattr(mod, src[1]))
    return vals


ANNOTATIONS = ("gpubench.", "boot.", "host.")    # the host ranges the benchmark names


class _host_encodes:
    """The engine's host-side encodes (CKKS.ecd, CKKS.const_pt) as named
    host ranges in a capture, so that an idle gap inside one says so."""

    def __enter__(self):
        from torch.profiler import record_function

        from gpqhe_tpu_torch.scheme.engine import CKKS
        self.saved = {n: getattr(CKKS, n) for n in ("ecd", "const_pt")}

        def named(name, fn):
            def f(*args, **kw):
                with record_function("host." + name):
                    return fn(*args, **kw)
            return f
        for n, fn in self.saved.items():
            setattr(CKKS, n, named(n, fn))
        return self

    def __exit__(self, *exc):
        from gpqhe_tpu_torch.scheme.engine import CKKS
        for n, fn in self.saved.items():
            setattr(CKKS, n, fn)
        return False


def capture(kind, state, first: int, count: int, judged: set[int]) -> dict:
    """`count` requests under torch.profiler (host and device): the reduced
    capture, the counted launches, the outputs of the judged requests
    (judged: offsets from the first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench import devtrace

    clock = Clock(torch.device("cuda"))
    before = counter_values()
    kept, bad = {}, {}
    annotate = kind.annotate(state) if hasattr(kind, "annotate") else contextlib.nullcontext()
    torch.cuda.synchronize()
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with annotate, _host_encodes(), record_function("gpubench.window"):
            for i in range(first, first + count):
                with record_function("gpubench.request"):
                    outs, _, why = request(kind, state, i, clock)
                if why is not None:
                    bad[i] = why
                elif i - first in judged:
                    kept[i] = outs
    after = counter_values()
    delta = {k: {e: after[k][e] - before[k].get(e, 0) for e in after[k]} for k in after}
    events, win = [], None
    raw = prof.events()
    # a host range also shows on the device's timeline as an annotation
    # spanning its kernels: it is no device operation
    ranges = {e.name for e in raw if getattr(e, "is_user_annotation", False)}
    for e in raw:
        kind_ = "device" if e.device_type == DeviceType.CUDA else "host"
        if kind_ == "device" and (e.name in ranges or e.name.startswith(ANNOTATIONS)
                                  or getattr(e, "is_user_annotation", False)):
            continue
        a, b = e.time_range.start, e.time_range.end
        if kind_ == "host" and e.name == "gpubench.window":
            win = (a, b)
        events.append((e.name, kind_, a, b))
    if win is None:
        raise RuntimeError("the capture holds no gpubench.window range")
    red = devtrace.reduce_capture(events, win)
    counted = launched(delta)
    ok, seen = devtrace.events_complete(red["device_ops"], counted)
    red.update(complete=ok, seen=seen, requests=count,
               kept={i: [host_copy(o) for o in outs] for i, outs in kept.items()}, bad=bad)
    return red


def traced(cell: Cell, kind, state, seed: int, attempts: int = 3) -> dict:
    """The traced passes: a profiled stretch of whole requests (taken again
    while a capture lost device events), the op-trace counts of one request,
    and the request kind's synchronised spans."""
    import torch

    from gpqhe_tpu_torch.utils import trace as op_trace

    count = cell.traffic["trace_requests"]
    judged = judged_requests({**cell.traffic, "judge_within": count}, seed)
    # the same stretch once unprofiled, holding the same outputs: the
    # allocator's cache then serves the capture without new device memory
    held = []
    for i in range(count):
        outs = kind.call(state, i)
        if i in judged:
            held.append(outs)
    torch.cuda.synchronize()
    del held
    cap = None
    for a in range(attempts):
        cap = capture(kind, state, a * count, count, judged)
        if cap["complete"]:
            break
        print(f"gpubench: capture {a + 1} lost device events {cap['seen']}", file=sys.stderr)
    print(f"gpubench: capture kernels seen / launched {cap['seen']}", file=sys.stderr)
    nxt = attempts * count
    with op_trace.op_trace() as tr:
        kind.call(state, nxt)
        torch.cuda.synchronize()
    spans = kind.spans(state, nxt + 1) if hasattr(kind, "spans") else {}
    return {"capture": cap if cap["complete"] else None, "last": cap,
            "requests": count, "outputs": count * cell.traffic["batch"],
            "counts": dict(tr.counts), "spans": spans,
            "sizes": kind.sizes(state) if hasattr(kind, "sizes") else {},
            "traffic": cell.traffic}


def per_layer(cell: Cell, reading: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        v = load_module("metrics", m["name"]).read(reading)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def breakdown(cap: dict) -> dict:
    mods = sorted(cap["module_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[m, s] for m, s in mods], "idle_gaps": cap["idle_gaps"][:10]}


# ---------------------------------------------------------------------------
# judgement
# ---------------------------------------------------------------------------

def judge(cell: Cell, inputs: dict, kept: dict, bad: dict, decoded=None) -> dict:
    """The numbers compared, each with its limit: the widest gap between a
    judged output's slots (decrypted and decoded by the plain reference, or
    given by `decoded`) and the plaintext circuit in float64; the requests
    that failed (run errors, missing outputs, the kind's own check)."""
    from gpubench.reference import ckks
    ref = cell.reference
    worst = 0.0
    failed = set(bad)
    n = 0
    for i, outs in sorted(kept.items()):
        items = [item_of(cell.traffic, i, k) for k in range(len(outs))]
        want = ref.circuit(inputs, items, cell.cfg, "float64")
        got = decoded(items) if decoded is not None else np.stack(
            [ckks.decrypt_decode(o, inputs["s"], cell.cfg) for o in outs])
        err = float(np.max(np.abs(got - want)))
        if not np.isfinite(err):
            err = float(np.finfo(np.float64).max)
        if err > cell.limits["max_err"]:
            failed.add(i)
        worst = max(worst, err)
        n += len(outs)
    return {"checks": {"max_err": {"value": worst, "limit": cell.limits["max_err"]},
                       "failed_requests": {"value": len(failed), "limit": 0},
                       "judged_outputs": {"value": n, "limit": 1}},
            "failed": len(failed)}


def control(cell: Cell, seed: int, device: str = "cpu") -> dict:
    """The control: the reference circuit, computed in the precision the
    cell file names (the nearest below the configuration's), put in the
    program's place for the judged requests of a run with this seed.  Not
    part of a benchmark run; its tests must see it come out not correct."""
    t = cell.traffic
    inputs = cell.reference.inputs(cell.cfg, t, np.random.default_rng(seed))
    kept = {i: [None] * t["batch"] for i in judged_requests(t, seed)}
    # a plaintext refreshes no levels: its result stays at the input's level
    bad = {i: f"level {t['level_in']} < {t['min_level']}" for i in kept
           if t.get("level_in", 0) < t.get("min_level", 0)}

    def decoded(items):
        return cell.reference.circuit(inputs, items, cell.cfg, cell.control, device)
    return judge(cell, inputs, kept, bad, decoded)


def correct(checks: dict) -> bool:
    c = checks
    return (c["max_err"]["value"] <= c["max_err"]["limit"]
            and c["failed_requests"]["value"] <= c["failed_requests"]["limit"]
            and c["judged_outputs"]["value"] >= c["judged_outputs"]["limit"])


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def device_info(device, count: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": int(torch.cuda.max_memory_reserved(device))}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run; returns the result object (its keys in the line's order)."""
    import torch
    kind, ref = cell.kind, cell.reference
    marks = [("start", t_start), ("import", time.perf_counter())]
    inputs = ref.inputs(cell.cfg, cell.traffic, np.random.default_rng(seed))
    state = kind.setup(cell.cfg, cell.traffic, inputs, seed, device)
    marks.append(("keys, pool", time.perf_counter()))
    for i in range(cell.traffic["warmup"]):
        kind.call(state, i)
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    captures = state.eng.ring.graphs.captures
    # what set-up made lives to the end: later collections need not walk it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    print("gpubench: set-up s " + ", ".join(f"{n} {b - a:.3f}" for (_, a), (n, b)
                                           in zip(marks, marks[1:])), file=sys.stderr)
    if trace:
        reading = traced(cell, kind, state, seed)
        cap = reading["last"]
        kept, bad, attempted = cap["kept"], cap["bad"], reading["requests"]
    else:
        loop = window(cell, kind, state, seconds, judged_requests(cell.traffic, seed), device)
        kept, bad, attempted = loop["kept"], loop["bad"], loop["requests"]
    grew = state.eng.ring.graphs.captures - captures
    if grew:
        print(f"gpubench: {grew} CUDA graph captures inside the measured window",
              file=sys.stderr)
    dev = device_info(device, cell.chips)
    metrics = per_layer(cell, reading) if trace else end_to_end(
        cell, loop, setup_s, dev["memory_peak_bytes"])
    del state
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = judge(cell, inputs, kept, bad)
    out = {"correct": correct(verdict["checks"]), "attempted": attempted,
           "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if trace and reading["capture"] is not None:
        c = reading["capture"]
        dev.update(busy_s=c["busy_s"], window_s=c["window_s"])
        out["breakdown"] = breakdown(c)
    out["checks"] = verdict["checks"]
    for i, why in sorted(bad.items())[:10]:
        print(f"gpubench: request {i} failed: {why}", file=sys.stderr)
    return out
