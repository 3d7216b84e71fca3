"""Engine programs replayed as CUDA graphs: the port's counterpart of
gpqhe_tpu/utils/xla.py::tpu_jit.

The JAX package compiles each engine program once per cache key (the op,
the level, the shapes) and then runs it with one host dispatch.  Here a
Program wraps such a program.  On a CUDA device it holds one CUDA graph per
(argument shapes and dtypes, device), jit's retrace rule: a new shape
captures, the same shape replays.  On a CPU tensor it is the program
itself, run eagerly.

The first call of a shape runs the program once eagerly on a side stream
and returns that result.  The run builds what the program fills lazily
(Barrett tables, plan caches, galois maps, cuBLAS's workspace, the four-step
stage's shared-memory limit), so that the capture which follows issues
device work only.  The capture goes into the engine's memory pool (one per
engine and device: the graphs replay one after another on one stream, so
they share it), its arguments copied into static buffers allocated outside
the pool.  A later call copies its arguments into those buffers, replays the
graph and returns clones of the graph's outputs, so that a replay never
overwrites a result the caller holds, as a jitted program's arrays are never
overwritten.

The counters of ops/cuda_build.COUNTERS (the kernels' launches, and the
bytes a mesh's collectives move: parallel/mesh.py's TRAFFIC) are bumped in
Python, which a replay does not run: what a capture added to them is taken
back and added again on every replay, so they stay counts of device work.

Each call outside another program's first call is a span of the op trace
and the profiler (utils/trace.py): `replay.<head>` around a replay (on a
CPU tensor or under disabled(), around the program itself) and
`capture.<head>` around a first call, <head> the key's first element or the
name the program was given; a first call's host seconds are also added to
trace.SETUP.

disabled() runs every program eagerly, as jax.disable_jit() does; nothing
else does.  A capture or replay that fails raises: there is no fallback.  A
program called while another one runs its first call (an op built from
another op's program) runs as a plain function, part of the outer graph, as
a jitted function inlines into the jit that calls it.

tpu_jit's other two parts, the TPU's scoped-VMEM compile option and the
retry of a remote compile, have no counterpart on a GPU.
"""

from __future__ import annotations

import gc
import time
from collections import OrderedDict
from contextlib import contextmanager

import torch

from ..ops import cuda_build
from . import trace

_DISABLED = 0       # depth of disabled() blocks
_INSIDE = 0         # depth of inline() blocks: first calls under way
MAX_GRAPHS = 64     # graphs a program with bound arguments keeps


@contextmanager
def disabled():
    """Run every program eagerly inside the block (jax.disable_jit())."""
    global _DISABLED
    _DISABLED += 1
    try:
        yield
    finally:
        _DISABLED -= 1


@contextmanager
def inline():
    """Programs called inside the block run as plain functions, part of the
    program whose first call (warm-up and capture) runs the block."""
    global _INSIDE
    _INSIDE += 1
    try:
        yield
    finally:
        _INSIDE -= 1


def inlining() -> bool:
    """Whether a program's first call (warm-up and capture) is under way."""
    return _INSIDE > 0


# -- the launch counters ----------------------------------------------------

def counters_snapshot() -> list[dict]:
    """A copy of every launch counter (ops/cuda_build.COUNTERS)."""
    return [dict(d) for d in cuda_build.COUNTERS]


def counters_restore(snap: list[dict]) -> None:
    for d, s in zip(cuda_build.COUNTERS, snap):
        d.clear()
        d.update(s)


def counters_delta(before: list[dict]) -> list[dict]:
    """What each counter gained since the snapshot `before` (nonzero only)."""
    return [{k: v - b.get(k, 0) for k, v in d.items() if v != b.get(k, 0)}
            for d, b in zip(cuda_build.COUNTERS, before)]


def _counters_add(delta: list[dict]) -> None:
    for d, dd in zip(cuda_build.COUNTERS, delta):
        for k, v in dd.items():
            d[k] = d.get(k, 0) + v


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    raise TypeError(f"a graphed program returns tensors or tuples of them, got {type(out)}")


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(x) for x in out)


# -- the capture primitive --------------------------------------------------

class CudaGraphs:
    """The capture primitive on CUDA devices, torch.cuda.CUDAGraph: each
    device's warm-ups and captures on a side stream of its own."""

    def __init__(self):
        self._side: dict = {}

    def takes(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def new_pool(self, device: torch.device):
        return torch.cuda.graph_pool_handle()

    def _stream(self, device: torch.device):
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device)
        return self._side[device]

    def warm_up(self, fn, args, device: torch.device):
        """fn(*args) eagerly on the side stream, ordered after the current
        stream's work and before its next."""
        cur = torch.cuda.current_stream(device)
        side = self._stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args)
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
        return out

    def capture(self, fn, args, pool, device: torch.device):
        """Capture fn(*args) into the pool: (replay, the graph's outputs).
        The garbage collector is off meanwhile: a graph it would free (a
        dropped engine's) cannot be destroyed, nor its pool released, while
        a stream captures."""
        g = torch.cuda.CUDAGraph()
        side = self._stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device), torch.cuda.stream(side):
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = fn(*args)
                finally:
                    g.capture_end()
        finally:
            if collecting:
                gc.enable()
        index = device.index if device.index is not None else torch.cuda.current_device()

        def replay():
            if torch.cuda.current_device() == index:
                g.replay()
            else:
                with torch.cuda.device(index):
                    g.replay()
        return replay, out


CUDA_GRAPHS = CudaGraphs()


# -- programs ---------------------------------------------------------------

class Graphs:
    """One engine's graphs: the capture primitive, one memory pool per
    device shared by all of the engine's graphs, and counts of captures and
    replays."""

    def __init__(self, capture=None):
        self.capture = CUDA_GRAPHS if capture is None else capture
        self._pools: dict = {}
        self.captures = 0
        self.replays = 0

    def pool(self, device: torch.device):
        if device not in self._pools:
            self._pools[device] = self.capture.new_pool(device)
        return self._pools[device]

    def program(self, fn, key=None, bound=(), name=None, graphed=True) -> "Program":
        return Program(fn, self, key, bound, name, graphed)


class _Graph:
    """One captured graph: its static inputs and outputs, its replay, and
    the launch counters' change that one run of the program makes."""

    def __init__(self, owner: Graphs, static_in, static_out, replay, delta):
        self.owner = owner
        self.static_in = static_in
        self.static_out = static_out
        self.replay = replay
        self.delta = delta

    def __call__(self, *args):
        for s, a in zip(self.static_in, args):
            if s is not None:
                s.copy_(a)
        self.replay()
        _counters_add(self.delta)
        self.owner.replays += 1
        return _clone(self.static_out)


class Program:
    """An engine program under its cache key: a graph per (argument shapes
    and dtypes, device) where the capture primitive takes the device, the
    program itself elsewhere, under disabled() and inside another program's
    first call.  Arguments are tensors, all on one device.

    bound: positions of arguments that the graph reads in place, by address,
    in place of a copy (large constants such as a plan's key stacks): their
    address and strides join the graph's key, so a graph replays only for
    the memory it was captured on, which then holds the argument.  A program
    with bound arguments keeps its MAX_GRAPHS most recently used graphs.

    name: the head its calls are traced under (the key's first element by
    default); graphed=False: the program itself on every device."""

    def __init__(self, fn, owner: Graphs, key=None, bound=(), name=None, graphed=True):
        self.fn = fn
        self.owner = owner
        self.key = key
        self.bound = frozenset(bound)
        self.graphed = graphed
        self.graphs: OrderedDict = OrderedDict()
        self.name = name or (key[0] if isinstance(key, tuple) else str(key))
        self._replay, self._capture = "replay." + self.name, "capture." + self.name

    def _sig(self, dev, args) -> tuple:
        if not self.bound:
            return (dev,) + tuple((a.shape, a.dtype) for a in args)
        return (dev,) + tuple((a.shape, a.dtype, a.data_ptr(), a.stride()) if i in self.bound
                              else (a.shape, a.dtype) for i, a in enumerate(args))

    def __call__(self, *args):
        if _INSIDE:
            return self.fn(*args)
        dev = args[0].device
        if _DISABLED or not self.graphed or not self.owner.capture.takes(dev):
            run = self.fn
        else:
            sig = self._sig(dev, args)
            run = self.graphs.get(sig)
            if run is None:
                return self._first_call(args, dev, sig)
            if self.bound:
                self.graphs.move_to_end(sig)
        if not trace.on():
            return run(*args)
        with trace.span(self._replay, dev, self.name):
            return run(*args)

    def _first_call(self, args, dev, sig):
        for a in args[1:]:
            if a.device != dev:
                raise ValueError(f"program {self.key}: arguments on {a.device} and {dev}")
        with trace.span(self._capture, dev, self.name):
            out, self.graphs[sig] = self._first(args, dev)
        if len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return out

    def _first(self, args, dev):
        """Warm up (the call's result), then capture into static buffers."""
        owner = self.owner
        t0 = time.perf_counter()
        with inline():
            out = owner.capture.warm_up(self.fn, args, dev)
            static_in = [None if i in self.bound else a.clone(memory_format=torch.contiguous_format)
                         for i, a in enumerate(args)]
            before = counters_snapshot()
            try:
                replay, static_out = owner.capture.capture(
                    self.fn, [a if s is None else s for s, a in zip(static_in, args)],
                    owner.pool(dev), dev)
                delta = counters_delta(before)
            except Exception as e:
                raise RuntimeError(f"capture of program {self.key} failed: {e}") from e
            finally:
                counters_restore(before)
        owner.captures += 1
        trace.SETUP["capture_s"] += time.perf_counter() - t0
        trace.SETUP["captures"] += 1
        return out, _Graph(owner, static_in, static_out, replay, delta)
