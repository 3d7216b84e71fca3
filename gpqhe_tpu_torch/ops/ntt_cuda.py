"""Hand-written CUDA NTT (csrc/ntt.cu) with its plan tables, launch counters
and the dispatch between kernel and plain twin.

Replaces the TPU kernel gpqhe_tpu/ops/ntt_pallas.py::_ntt_kernel and its
wrapper ntt_pallas: forward NTT, inverse NTT, and inverse scaled by
n^-1 * phat^-1 (the CRT reconstruct's fused first step).  The kernel takes
standard-domain twiddles with Shoup companions floor(z * 2^64 / p), as the
Pallas plan built them (ntt_pallas.py:418-426); here they are computed once
per ring for every prime of the chain, vectorised over numpy object arrays,
and a dim-prime plan points at the first dim rows.

Dispatch: a CPU tensor goes through the plain twin (ops/ntt.py); a CUDA
tensor launches the kernel, which raises if it cannot.  There is no other
fallback.  LAUNCHES counts kernel launches per entry.

The library is built with nvcc for sm_90a at first use into build/kernels/
at the repository root, named by the hash of the source and flags, and
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from . import ntt as twin
from .modmath import u64_to_torch

LAUNCHES = {"fwd": 0, "inv": 0, "inv_scaled": 0}

LOGN_MIN, LOGN_MAX = 4, 16
_MAX_SLABS = 65535            # grid.y of the global-memory stage pass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ntt.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
BUILD_LOG = ""                # nvcc's output of the last build (ptxas -v)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA NTT needs the CUDA toolkit")
    return found


def load_library():
    """Build (if the source changed) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"ntt_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                                 capture_output=True, text=True)
            BUILD_LOG = out.stdout + out.stderr
            if out.returncode != 0:
                raise RuntimeError(f"nvcc failed ({out.returncode}):\n{BUILD_LOG}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gpqhe_ntt.argtypes = [vp, vp, i64, i32, i32, vp, vp, vp, vp, vp, i32, vp]
    lib.gpqhe_ntt.restype = i32
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# plan tables
# ---------------------------------------------------------------------------

def std_and_shoup(zmont: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Montgomery-domain table (z*R mod p, R = 2^64) -> (standard-domain z,
    Shoup companions floor(z * 2^64 / p)), both u64, exact in Python ints."""
    rinv = pow(1 << 64, -1, p)
    z = (np.asarray(zmont, dtype=np.uint64).astype(object) * rinv) % p
    return z.astype(np.uint64), ((z << 64) // p).astype(np.uint64)


@dataclass(frozen=True)
class KernelTables:
    """Twiddle tables of every prime of a ring's chain: int64[dimub, n]
    (u64 bit patterns), rows in chain order."""
    primes: torch.Tensor
    tw_f: torch.Tensor
    tws_f: torch.Tensor
    tw_i: torch.Tensor
    tws_i: torch.Tensor


def make_kernel_tables(pctx, device) -> KernelTables:
    if max(pctx.primes) >= 1 << 61:
        raise ValueError("the CUDA NTT's lazy < 8p bounds need primes < 2^61")
    rows = {"tw_f": [], "tws_f": [], "tw_i": [], "tws_i": []}
    for pc in pctx.prime_ctx:
        for key, table in (("f", pc.zetas), ("i", pc.zetas_inv)):
            z, zs = std_and_shoup(table, pc.p)
            rows["tw_" + key].append(z)
            rows["tws_" + key].append(zs)
    return KernelTables(
        primes=u64_to_torch(np.array(pctx.primes, dtype=np.uint64), device),
        **{k: u64_to_torch(np.stack(v), device) for k, v in rows.items()})


@dataclass(frozen=True)
class NttPlan:
    """One dim-prime basis: the twin's Montgomery tables (from BasisArrays)
    and, for a CUDA ring, the kernel's tables and scale constants."""
    dim: int
    n: int
    ba: object                       # rns.BasisArrays
    tables: KernelTables | None
    scale: torch.Tensor | None       # int64[2, dim]: n^-1 and its Shoup companion
    scale_phat: torch.Tensor | None  # int64[2, dim]: n^-1 phat^-1 and companion


def make_plan(pctx, dim: int, ba, tables: KernelTables | None) -> NttPlan:
    if tables is None:
        return NttPlan(dim, pctx.n, ba, None, None, None)
    b = pctx.basis(dim)
    rows = {"n": [], "np": []}
    for d, p in enumerate(b.primes):
        ninv = pow(pctx.n, -1, p)
        for key, s in (("n", ninv), ("np", ninv * b.phat_invmp[d] % p)):
            rows[key].append((s, (s << 64) // p))
    dev = tables.primes.device

    def t(vals):
        return u64_to_torch(np.array(vals, dtype=np.uint64).T, dev)
    return NttPlan(dim, pctx.n, ba, tables, t(rows["n"]), t(rows["np"]))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def check_args(a: torch.Tensor, plan: NttPlan) -> tuple[int, int]:
    """Validate a kernel call; returns (log2 n, number of slabs)."""
    if a.dtype != torch.int64:
        raise ValueError(f"the CUDA NTT takes int64 residues, got {a.dtype}")
    n = a.shape[-1]
    logn = n.bit_length() - 1
    if n != 1 << logn or not LOGN_MIN <= logn <= LOGN_MAX:
        raise ValueError(f"n = {n}: the CUDA NTT supports n = 2^{LOGN_MIN}..2^{LOGN_MAX}")
    if a.ndim < 2 or a.shape[-2] != plan.dim or n != plan.n:
        raise ValueError(f"shape {tuple(a.shape)} does not match plan [..., {plan.dim}, {plan.n}]")
    nslab = a.numel() // n
    if nslab > _MAX_SLABS:
        raise ValueError(f"{nslab} slabs exceed the kernel's {_MAX_SLABS}")
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA NTT takes CUDA tensors, got {a.device}")
    if plan.tables is None or plan.tables.primes.device != a.device:
        raise ValueError("NTT plan has no kernel tables on this tensor's device")
    return logn, nslab


def _launch(a: torch.Tensor, plan: NttPlan, inverse: bool, scaled: bool):
    logn, nslab = check_args(a, plan)
    a = a.contiguous()
    out = torch.empty_like(a)
    if nslab == 0:
        return out
    lib = load_library()
    t = plan.tables
    tw, tws = (t.tw_i, t.tws_i) if inverse else (t.tw_f, t.tws_f)
    sc = plan.scale_phat if scaled else plan.scale
    rc = lib.gpqhe_ntt(a.data_ptr(), out.data_ptr(), nslab, plan.dim, logn,
                       tw.data_ptr(), tws.data_ptr(), t.primes.data_ptr(),
                       sc[0].data_ptr(), sc[1].data_ptr(), int(inverse),
                       torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gpqhe_ntt launch failed: cudaError {rc}")
    LAUNCHES["inv_scaled" if scaled else "inv" if inverse else "fwd"] += 1
    return out


def ntt(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward NTT of [..., dim, n] residues < p, bit-reversed order."""
    if a.device.type == "cpu":
        ba = plan.ba
        return twin.ntt(a, ba.zetas, ba.ps, ba.pinv)
    return _launch(a, plan, inverse=False, scaled=False)


def intt(a: torch.Tensor, plan: NttPlan, scaled: bool = False) -> torch.Tensor:
    """Inverse NTT, times n^-1 (scaled=False) or n^-1 * phat^-1 (scaled=True)."""
    if a.device.type == "cpu":
        ba = plan.ba
        return twin.intt(a, ba.zetas_inv, ba.ps, ba.pinv,
                         ba.ninvphat_mont if scaled else ba.ninv_mont)
    return _launch(a, plan, inverse=True, scaled=scaled)
