"""Perf-measurement utilities (the libpmu role, ref: Makefile:24-26): wall-
clock op timers, the torch.profiler trace wrapper, and a simple per-call
timer for benches.  Port of gpqhe_tpu/utils/pmu.py: device work is awaited
with torch.cuda.synchronize and timed with CUDA events on the card."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from .trace import block_until_ready, device_trace  # noqa: F401  (re-exported)


@dataclass
class Timer:
    """Accumulating named timer: with t.measure("ntt", block_on=out): ..."""
    records: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def measure(self, name: str, block_on=None):
        """block_on: a tensor (or nest of tensors) whose device is awaited
        before the clock stops."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        dt = time.perf_counter() - t0
        cnt, tot = self.records.get(name, (0, 0.0))
        self.records[name] = (cnt + 1, tot + dt)

    def report(self, out=print):
        for name, (cnt, tot) in sorted(self.records.items()):
            out(f"{name:24s} {cnt:5d} calls  {tot:8.3f}s total  {tot/cnt*1e3:8.2f} ms/call")


def _first_cuda_device(x):
    if isinstance(x, torch.Tensor):
        return x.device if x.is_cuda else None
    if isinstance(x, (tuple, list)):
        for y in x:
            d = _first_cuda_device(y)
            if d is not None:
                return d
    return None


def time_jitted(fn, args, iters: int = 10, warmup: int = 2) -> float:
    """Median-free simple timing: returns seconds per call after warmup.
    Where fn's result lies on a card the iters calls are timed between two
    CUDA events on its stream; on the CPU with perf_counter."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    block_until_ready(out)
    dev = _first_cuda_device(out)
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            out = fn(*args)
        b.record()
        b.synchronize()
    return a.elapsed_time(b) / 1e3 / iters
