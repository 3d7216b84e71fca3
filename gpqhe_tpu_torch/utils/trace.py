"""Tracing of the torch port (gpqhe_tpu/utils/trace.py): spans and counters
recorded where the work happens, read through an op trace or a profiler.

- `span(name, device)` — a named stretch of the program.  With no op trace
  active and no torch.profiler running it returns one shared null context
  (a flag check a span point).  Under the profiler it is a
  `record_function` range, on the clock of the device's events; under
  `op_trace()` it records its host seconds and, on a CUDA device, a pair
  of CUDA events on the current stream (from a pool of POOL made when the
  block opens, before its clocks start): the device's time from the
  stream's finishing what was queued before the span to the end of the
  span's own work.  Nothing waits inside the block: its events are resolved
  by one synchronise when the block ends.  No event is recorded while a
  stream captures or a program's first call runs (utils/graphs.py).
- Program calls are spans the engines' programs record themselves
  (utils/graphs.py::Program): `replay.<head>` around a run (a graph's
  replay on a card, the program itself elsewhere), `capture.<head>` around
  a first call (warm-up and capture), under the head of the key the JAX
  engines cache their jitted programs by ('he_mul_rs', 'swk', 'gal', 'rs',
  'add2', 'fwd', 'mul', ...).  A program called inside another one's first
  call runs as part of it and records nothing, as a jitted program counts
  once whatever it inlines; a composite that another program contains (the
  forward NTTs inside 'mul', 'swk' or 'he_mulpt', 'he_mul' inside
  'he_mul_rs') is reached through its bare function.  One mul_rs, rot,
  conj, add, mulpt, rs, moddown, enc, dec or hoisted gemv therefore counts
  the same names the same number of times in both packages once the
  programs exist.  What the port cannot count alike: the first call of an
  op, where the JAX package also counts the programs it traces while
  building another ('he_mul' inside the first 'he_mul_rs' of a level).
- `op_trace()` — a block that collects every span and program call, and
  the change of every launch and copy counter (ops/cuda_build.COUNTERS),
  into an OpTrace; `last()` is the last block that ended.
- Counters: `H2D`, the bytes and copies of host limbs put on a device
  (scheme/types.py::limbs_to_torch, every device, the CPU included), and
  `ENCODE`, the constant and encoded plaintexts by route (scheme/engine.py:
  `on_card`, few nonzero rows filled on the engine's device by
  ops/limbs.py::fill_rows; `host`, dense limbs built on the host and
  copied), both in ops/cuda_build.COUNTERS; `SETUP`, process totals always kept: host
  seconds in switch-key generation outside first calls (`keygen_s`, kept
  by scheme/engine.py::CKKS.genswk), host
  seconds in programs' first calls (`capture_s`) and their count.
- `device_trace(logdir)` — a torch.profiler capture (CPU and, on a CUDA
  build, the card), written as a Chrome trace into logdir when the block
  ends (view in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _profiler

from ..ops import cuda_build
from . import graphs

_ACTIVE: "OpTrace | None" = None
_LAST: "OpTrace | None" = None

H2D = cuda_build.counters({"bytes": 0, "copies": 0})
ENCODE = cuda_build.counters({"on_card": 0, "host": 0})
SETUP = {"keygen_s": 0.0, "capture_s": 0.0, "captures": 0}
_FREE: dict = {}    # CUDA device -> timing events resolved, free for reuse
POOL = 1024         # events an op_trace block finds made on its device


def on() -> bool:
    """Whether spans record: an op trace is active or a profiler runs."""
    return _ACTIVE is not None or _profiler._is_profiler_enabled


def _event(device):
    """A timing event recorded on device's current stream, or None off a
    card, inside a program's first call and while the stream captures."""
    if (device is None or device.type != "cuda" or graphs.inlining()
            or torch.cuda.is_current_stream_capturing()):
        return None
    free = _FREE.setdefault(device, [])
    e = free.pop() if free else torch.cuda.Event(enable_timing=True)
    e.record(torch.cuda.current_stream(device))
    return e


def _fill(device) -> None:
    """Make device's free events up to POOL before a block's clocks start:
    an event's first record creates it (~13 us of host time), which a span
    would otherwise pay inside its own time."""
    free = _FREE.setdefault(device, [])
    stream = torch.cuda.current_stream(device)
    for _ in range(POOL - len(free)):
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        free.append(e)


def _device(device):
    """device as a torch.device, a CUDA one with its index."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass
class OpTrace:
    """What one op_trace block recorded.

    counts, seconds: program calls and their time, by key head; the
        device's clock (events) on a card, the host's elsewhere.
    spans: span name -> [(host_s, device_s), ...] in the order they ended;
        device_s is None off a card.
    counters: the block's change in each of ops/cuda_build.COUNTERS
        (`counter(d)` reads one).
    device_s: the whole block on the device's clock (None off a card)."""
    counts: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    counters: list = field(default_factory=list)
    device_s: float | None = None
    _pending: list = field(default_factory=list, repr=False)
    _registered: list = field(default_factory=list, repr=False)

    def _add(self, name: str, head, host_s: float, events) -> None:
        """events: (device, e0, e1) or None."""
        rec = [host_s, None]
        self.spans.setdefault(name, []).append(rec)
        if head is not None:
            self.counts[head] = self.counts.get(head, 0) + 1
            self.seconds.setdefault(head, 0.0)
        if events is not None:
            self._pending.append((rec, head) + events)
        elif head is not None:
            self.seconds[head] += host_s

    def _resolve(self) -> None:
        """One synchronise (a device), then every span's device seconds."""
        for device in {p[2] for p in self._pending}:
            torch.cuda.synchronize(device)
        for rec, head, device, e0, e1 in self._pending:
            rec[1] = e0.elapsed_time(e1) * 1e-3
            if head is not None:
                self.seconds[head] += rec[1]
            _FREE[device] += (e0, e1)
        self._pending.clear()
        self.spans = {k: [tuple(r) for r in v] for k, v in self.spans.items()}

    def counter(self, d: dict) -> dict:
        """The block's change in the registered counter d (nonzero keys)."""
        for c, delta in zip(self._registered, self.counters):
            if c is d:
                return delta
        return {}

    def report(self) -> str:
        lines = [f"{'op':<12} {'calls':>6} {'total ms':>10} {'ms/call':>9}"]
        for name in sorted(self.seconds, key=self.seconds.get, reverse=True):
            c = self.counts[name]
            s = self.seconds[name] * 1e3
            lines.append(f"{name:<12} {c:>6} {s:>10.2f} {s / c:>9.2f}")
        return "\n".join(lines)


@contextmanager
def op_trace():
    """Collect spans, program calls and counters; yields the OpTrace being
    filled, complete once the block has ended.

        with op_trace() as t:
            eng.mul(ct1, ct2, rlk)
        print(t.report())
    """
    global _ACTIVE, _LAST
    prev = _ACTIVE
    _ACTIVE = t = OpTrace(_registered=list(cuda_build.COUNTERS))
    before = [dict(d) for d in t._registered]
    dev = _device("cuda") if torch.cuda.is_initialized() else None
    if dev is not None and not torch.cuda.is_current_stream_capturing():
        _fill(dev)
    e0 = _event(dev)
    try:
        yield t
    finally:
        _ACTIVE = prev
        e1 = None if e0 is None else _event(dev)
        block = [None, None]
        if e1 is not None:
            t._pending.append((block, None, dev, e0, e1))
        t._resolve()
        t.device_s = block[1]
        t.counters = [{k: v - b.get(k, 0) for k, v in d.items() if v != b.get(k, 0)}
                      for d, b in zip(t._registered, before)]
        _LAST = t


def last() -> "OpTrace | None":
    """The last op_trace block that ended (None before the first)."""
    return _LAST


class _Span:
    __slots__ = ("name", "device", "head", "trace", "rf", "t0", "e0")

    def __init__(self, name: str, device, head):
        self.name, self.device, self.head = name, device, head

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.trace = _ACTIVE
        self.e0 = None if self.trace is None else _event(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = self.trace
        if t is not None and t is _ACTIVE:
            host_s = time.perf_counter() - self.t0
            e1 = None if self.e0 is None else _event(self.device)
            t._add(self.name, self.head, host_s,
                   None if e1 is None else (self.device, self.e0, e1))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


NULL = nullcontext()


def span(name: str, device=None, program: str | None = None):
    """The span `name` (on `device`, where its events go); `program`: the
    key head this span counts as a program call under (utils/graphs.py).
    The shared null context when nothing records."""
    if not on():
        return NULL
    return _Span(name, _device(device), program)


def block_until_ready(out) -> None:
    """Wait for the device work behind every CUDA tensor in out (a tensor,
    or nested tuples/lists of them).  CPU tensors are ready already."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            block_until_ready(x)


@contextmanager
def device_trace(logdir: str):
    """Timeline capture with torch.profiler: host ops and, where there is a
    card, its kernels.  Writes logdir/trace.json (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
