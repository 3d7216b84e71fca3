"""Tracing / profiling subsystem of the torch port (gpqhe_tpu/utils/trace.py).

- `op_trace()` — per-op counters: while a trace is active every engine
  program is counted and synchronously timed under the head of the key the
  JAX engines cache their jitted programs by ('he_mul_rs', 'swk', 'gal',
  'rs', 'add2', 'fwd', 'mul', ...).  The torch engines cache their programs
  under the same keys (on a CUDA device each a CUDA graph per shape,
  utils/graphs.py, which this wrapper times from outside: a replay); a
  composite that another program contains (the forward NTTs inside 'mul',
  'swk' or 'he_mulpt') is reached through its unwrapped form and not
  counted, as a jitted program counts once whatever it inlines, and
  neither is a program called inside another one's first call (the galois
  maps inside the mesh's sharded rot).  One
  mul_rs, rot, conj, add, mulpt, rs, moddown, enc, dec or hoisted gemv
  therefore counts the same names the same number of times in both
  packages once the programs exist.  What the port cannot
  count alike: the first call of an op, where the JAX package also counts
  the programs it traces while building another ('he_mul' inside the first
  'he_mul_rs' of a level).  Zero overhead when inactive: `maybe_wrap`
  returns the callable it was given.
- `device_trace(logdir)` — a torch.profiler capture (CPU and, on a CUDA
  build, the card), written as a Chrome trace into logdir when the block
  ends (view in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from . import graphs

_ACTIVE: "OpTrace | None" = None


@dataclass
class OpTrace:
    """Accumulated per-op counts and wall time, keyed by the engine's
    program key head (e.g. 'he_mul', 'swk', 'rs', 'fwd')."""
    counts: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def record(self, key, sec: float) -> None:
        name = key[0] if isinstance(key, tuple) else str(key)
        self.counts[name] = self.counts.get(name, 0) + 1
        self.seconds[name] = self.seconds.get(name, 0.0) + sec

    def report(self) -> str:
        lines = [f"{'op':<12} {'calls':>6} {'total ms':>10} {'ms/call':>9}"]
        for name in sorted(self.seconds, key=self.seconds.get, reverse=True):
            c = self.counts[name]
            s = self.seconds[name] * 1e3
            lines.append(f"{name:<12} {c:>6} {s:>10.2f} {s / c:>9.2f}")
        return "\n".join(lines)


@contextmanager
def op_trace():
    """Activate per-op tracing; yields the OpTrace being filled.

        with op_trace() as t:
            eng.mul(ct1, ct2, rlk)
        print(t.report())
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = t = OpTrace()
    try:
        yield t
    finally:
        _ACTIVE = prev


def block_until_ready(out) -> None:
    """Wait for the device work behind every CUDA tensor in out (a tensor,
    or nested tuples/lists of them).  CPU tensors are ready already."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            block_until_ready(x)


def maybe_wrap(key, fn):
    """Hook for the engines' programs: identity when no trace is active;
    otherwise a sync-timing wrapper (it waits for the device after every
    call, so only use while profiling)."""
    if _ACTIVE is None:
        return fn
    trace_obj = _ACTIVE

    def timed(*args, **kw):
        if graphs.inlining():
            # part of another program's first call, whose capture may not
            # wait for the device: that program is the one timed
            return fn(*args, **kw)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        block_until_ready(out)
        trace_obj.record(key, time.perf_counter() - t0)
        return out
    return timed


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
