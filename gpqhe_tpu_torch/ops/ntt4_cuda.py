"""Hand-written CUDA halves of the four-step NTT (csrc/ntt4.cu, K8):
bindings, launch counters and argument checks.

Replaces, on CUDA tensors, the elementwise work of gpqhe_tpu/ops/ntt4.py
around its f64 digit products (_moddot, ntt4, intt4): `split` turns u64
residues into the GEMM's f64 digit-plane operand, after the Montgomery
multiply that precedes the stage and with the transpose between the
stages; `combine` turns the GEMM's digit products into residues mod p and
applies the Montgomery multiply that follows the stage.  The products
themselves are one torch.bmm a stage (ops/ntt4.py).  ops/ntt4.py
dispatches here for a CUDA tensor; its plain_* functions serve the CPU.
LAUNCHES counts launches per entry.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "ntt4.cu")
GRID_Y = 65535          # the launches' grid.y: one block row a (poly, prime) slab
MAX_K = 256             # the contraction length for which the f64 sums stay exact

LAUNCHES = {"split": 0, "combine": 0}

_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gpqhe_ntt4_split": [_VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP],
    "gpqhe_ntt4_combine": [_VP, _VP, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP, _VP,
                           _VP],
}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> ctypes.CDLL:
    """Build (if the source changed) and load the library, entry points typed."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(rc: int, entry: str) -> None:
    if rc != 0:
        raise RuntimeError(f"ntt4 kernel {entry} failed to launch: cudaError {rc}")


def _table(t, shape: tuple, name: str):
    """The pointer of a contiguous int64 table of shape [dim, words] (any
    shape [dim, ...] of as many words), or None."""
    if t is None:
        return None
    cuda_build.check_dtype(t)
    if t.shape[:1] != shape[:1] or t.numel() != math.prod(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous table of {shape} words, got "
                         f"{tuple(t.shape)}{'' if t.is_contiguous() else ' (strided)'}")
    return t.data_ptr()


def _slabs(lead: tuple, dim: int) -> int:
    B = math.prod(lead)
    if B * dim > GRID_Y:
        raise ValueError(f"{B} polys x {dim} primes exceed the kernels' {GRID_Y} slabs")
    return B


def split(x, plan, rows: int, cols: int, transpose: bool, table) -> torch.Tensor:
    """[..., dim, rows * cols] residues (times table, then transposed if
    asked) -> the GEMM's f64 operand [dim, K, B * P * J] (see
    ntt4.plain_ntt4_split)."""
    dev = x.device
    dim, P = plan.dim, plan.planes
    if x.ndim < 2 or tuple(x.shape[-2:]) != (dim, rows * cols):
        raise ValueError(f"split takes [..., {dim}, {rows * cols}] residues, got {tuple(x.shape)}")
    cuda_build.check_dtype(x)
    K, J = (cols, rows) if transpose else (rows, cols)
    if K > MAX_K:
        raise ValueError(f"a contraction of {K} > {MAX_K}: the f64 digit sums would not be exact")
    tab = _table(table, (dim, K * J), "the split's table")
    cuda_build.check_device(dev, x, plan.ps, plan.pinv, *([table] if table is not None else []))
    lead = tuple(x.shape[:-2])
    B = _slabs(lead, dim)
    xc = x.contiguous()
    out = torch.empty((dim, K, B * P * J), dtype=torch.float64, device=dev)
    if out.numel():
        _check(load_library().gpqhe_ntt4_split(
            out.data_ptr(), xc.data_ptr(), B, dim, rows, cols, P, int(transpose), tab,
            plan.ps.data_ptr(), plan.pinv.data_ptr(), cuda_build.stream_of(dev)), "split")
        LAUNCHES["split"] += 1
    return out


def combine(y, plan, lead: tuple, m: int, j: int, table, scale) -> torch.Tensor:
    """The GEMM's digit products [dim, P * m, B * P * j] -> residues
    [*lead, dim, m * j] in [0, p), times table and scale (see
    ntt4.plain_ntt4_combine)."""
    dev = y.device
    dim, P = plan.dim, plan.planes
    B = _slabs(tuple(lead), dim)
    if tuple(y.shape) != (dim, P * m, B * P * j):
        raise ValueError(f"combine takes [{dim}, {P * m}, {B * P * j}] products, got "
                         f"{tuple(y.shape)}")
    cuda_build.check_dtype(y, dtype=torch.float64)
    if j & (j - 1):
        raise ValueError(f"combine's row length {j} is not a power of two")
    tab = _table(table, (dim, m * j), "the combine's table")
    sc = _table(scale, (dim,), "the combine's scale")
    cuda_build.check_device(dev, y, plan.ps, plan.pinv, plan.c_pow,
                            *[t for t in (table, scale) if t is not None])
    yc = y.contiguous()
    out = torch.empty(tuple(lead) + (dim, m * j), dtype=torch.int64, device=dev)
    if out.numel():
        _check(load_library().gpqhe_ntt4_combine(
            out.data_ptr(), yc.data_ptr(), B, dim, m, j.bit_length() - 1, P, tab, sc,
            plan.ps.data_ptr(), plan.pinv.data_ptr(), plan.c_pow.data_ptr(),
            cuda_build.stream_of(dev)), "combine")
        LAUNCHES["combine"] += 1
    return out
