"""Hand-written CUDA stage of the four-step NTT (csrc/ntt4.cu, K8): binding,
launch counter and argument checks.

Replaces, on CUDA tensors, one stage of gpqhe_tpu/ops/ntt4.py (_moddot with
the Montgomery multiplies around it, ntt4, intt4): `stage` computes
out = post * scale * (W @ (pre * X)) mod p on every (poly, prime) slab in
one launch, its product on the tensor cores in u8 digit planes (the plan's
byte planes of W), the transpose between the stages in how the tile is
loaded.  ops/ntt4.py dispatches here for a CUDA tensor; its plain_*
functions serve the CPU.  LAUNCHES counts launches per entry.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "ntt4.cu")
GRID_Y = 65535          # the launch's grid.y: one block row a (poly, prime) slab
MAX_K = 256             # the longest contraction: its s32 digit sums stay exact

LAUNCHES = cuda_build.counters({"stage": 0})

_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gpqhe_ntt4_stage": [_VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _VP,
                         _VP, _VP, _VP],
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


def stage(x, plan, w: str, rows: int, cols: int, transpose: bool, pre, post,
          scale) -> torch.Tensor:
    """One four-step stage on [..., dim, rows * cols] residues < p: one
    launch (see ntt4.plain_ntt4_stage for the arguments)."""
    dev = x.device
    dim, P8 = plan.dim, plan.planes8
    if x.ndim < 2 or tuple(x.shape[-2:]) != (dim, rows * cols):
        raise ValueError(f"a stage takes [..., {dim}, {rows * cols}] residues, got "
                         f"{tuple(x.shape)}")
    cuda_build.check_dtype(x)
    K, J = (cols, rows) if transpose else (rows, cols)
    if K > MAX_K:
        raise ValueError(f"a contraction of {K} > {MAX_K}: the s32 digit sums would not be exact")
    if K % 4 or J % 2:
        raise ValueError(f"a stage takes K a multiple of 4 and J even, got {K}, {J}")
    w8 = plan.w(w, "u8")
    if (tuple(w8.shape) != (dim, P8, K, K) or w8.dtype != torch.uint8
            or not w8.is_contiguous() or w8.data_ptr() % 16):
        raise ValueError(f"W's byte planes must be contiguous, 16-byte aligned u8 "
                         f"[{dim}, {P8}, {K}, {K}], got {w8.dtype} {tuple(w8.shape)}")
    tabs = [_table(pre, (dim, K * J), "the stage's pre-table"),
            _table(post, (dim, K * J), "the stage's post-table"),
            _table(scale, (dim,), "the stage's scale")]
    cuda_build.check_device(dev, x, w8, plan.ps, plan.pinv, plan.c32,
                            *[t for t in (pre, post, scale) if t is not None])
    lead = tuple(x.shape[:-2])
    B = math.prod(lead)
    if B * dim > GRID_Y:
        raise ValueError(f"{B} polys x {dim} primes exceed the kernel's {GRID_Y} slabs")
    xc = x.contiguous()
    out = torch.empty(lead + (dim, K * J), dtype=torch.int64, device=dev)
    if out.numel():
        _check(load_library().gpqhe_ntt4_stage(
            out.data_ptr(), xc.data_ptr(), w8.data_ptr(), B, dim, K, J, P8, int(transpose),
            *tabs, plan.ps.data_ptr(), plan.pinv.data_ptr(), plan.c32.data_ptr(),
            cuda_build.stream_of(dev)), "stage")
        LAUNCHES["stage"] += 1
    return out
