"""Build and load the package's CUDA libraries (csrc/*.cu).

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, into build/kernels/ at the repository
root; the file name carries the hash of the source and the flags, so an
unchanged source is not rebuilt.  build() compiles several sources at once,
one nvcc process each, all started together.  The libraries are loaded with
ctypes by the modules that bind them (ops/ntt_cuda.py, ops/ntt_cuda32.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def library_path(source: str) -> str:
    with open(source, "rb") as f:
        src = f.read()
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
    """Build (if the source changed) and load one library."""
    return ctypes.CDLL(build([source])[source])
