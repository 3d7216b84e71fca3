"""Build and load the package's CUDA libraries (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, into build/kernels/ at the repository
root; the file name carries the hash of the source, of the package headers
it includes (#include "x.cuh") and of the flags, so an unchanged source is
not rebuilt.  build() compiles several sources at once,
one nvcc process each, all started together.  The libraries are loaded with
ctypes by the modules that bind them (ops/*_cuda.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_LOGS: dict[str, str] = {}   # source path -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _with_includes(source: str) -> bytes:
    """The source's bytes followed by those of the headers it includes by
    quoted name from its own directory."""
    with open(source, "rb") as f:
        src = f.read()
    for name in re.findall(rb'^#include "([^"]+)"', src, flags=re.M):
        src += _with_includes(os.path.join(os.path.dirname(source), name.decode()))
    return src


def library_path(source: str) -> str:
    src = _with_includes(source)
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}_{tag}.so")


def build(sources: list[str]) -> dict[str, str]:
    """Compile every source whose library is missing, in parallel; returns
    {source: library path}.  Raises if any nvcc fails."""
    paths = {s: library_path(s) for s in sources}
    jobs = []
    for src, so in paths.items():
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in jobs:
        BUILD_LOGS[src] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{BUILD_LOGS[src]}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(source: str) -> ctypes.CDLL:
    """Build (if the source or a header it includes changed) and load one
    library."""
    return ctypes.CDLL(build([source])[source])


# ---------------------------------------------------------------------------
# operand views for the elementwise kernels (modmath.cu, rns.cu, limbs.cu)
# ---------------------------------------------------------------------------

# every launch counter of the kernel bindings (ops/*_cuda.py), COPIES
# below and the meshes' traffic (parallel/mesh.py): a replayed CUDA graph
# runs no Python, so utils/graphs.py adds again at each replay what the
# graph's capture added to them
COUNTERS: list[dict] = []


def counters(d: dict) -> dict:
    """Register a counter dict (name -> count) in COUNTERS; returns it."""
    COUNTERS.append(d)
    return d


COPIES = counters({"operands": 0})   # operands copied because their strides had no 3-axis form


def strides3(t, shape: tuple, lead: int = 0) -> tuple:
    """(tensor, sm, sa, sb, sc): t broadcast to shape and seen as [M, A, B, C]
    with element strides (0 on a broadcast axis).  The first `lead` axes
    (0 or 1) of shape are M, the last two B and C, and the axes between
    collapse into A; where their strides do not collapse, t is copied
    contiguous first (counted in COPIES)."""
    if len(shape) < lead + 2:
        raise ValueError(f"shape {shape}: the elementwise kernels take [..., rows, columns]")
    x = t if t.shape == shape else t.expand(shape)
    st = x.stride()
    if len(shape) - lead == 2:
        return (x, st[0] if lead else 0, 0, st[-2], st[-1])
    mid = [(shape[i], st[i]) for i in range(lead, len(shape) - 2) if shape[i] != 1]
    if len(mid) > 1 and any(s0 != s1 * n1 for (_, s0), (n1, s1) in zip(mid, mid[1:])):
        COPIES["operands"] += 1
        x = x.contiguous()      # the broadcast materialised: its axes collapse
        st = x.stride()
        mid = [(shape[i], st[i]) for i in range(lead, len(shape) - 2) if shape[i] != 1]
    return (x, st[0] if lead else 0, mid[-1][1] if mid else 0, st[-2], st[-1])


def check_dtype(*tensors, dtype=None) -> None:
    """Raise unless every tensor has `dtype` (int64 words by default)."""
    import torch
    want = dtype or torch.int64
    for x in tensors:
        if x.dtype != want:
            raise ValueError(f"the CUDA kernels take {want} here, got {x.dtype}")


def check_device(device, *tensors) -> None:
    """Raise unless `device` is a CUDA device and every tensor lies on it."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    for x in tensors:
        if x.device != device:
            raise ValueError(f"operands on {x.device} and {device}")


def broadcast_shape(*shapes) -> tuple:
    """The shape that the given shapes broadcast to (torch's rule, in plain
    Python: the wrappers' host time per call counts); ValueError where they
    do not broadcast (a prime axis that does not match)."""
    shapes = [tuple(s) for s in shapes]
    first = shapes[0]
    if all(s == first for s in shapes):
        return first
    out = []
    for i in range(1, max(len(s) for s in shapes) + 1):
        d = 1
        for s in shapes:
            v = s[-i] if i <= len(s) else 1
            if v != 1:
                if d not in (1, v):
                    raise ValueError(f"operands of shapes {shapes} do not broadcast "
                                     f"(axis {-i}: {d} against {v})")
                d = v
        out.append(d)
    return tuple(reversed(out))


def stream_of(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
