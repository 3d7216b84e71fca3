"""Hand-written CUDA limb chains (csrc/limbs.cu): bindings, launch counters and
argument checks.

Replaces, on CUDA tensors, the torch chains of ops/limbs.py that XLA fuses
inside each jitted program of the JAX package (gpqhe_tpu/ops/limbs.py:44-250:
add, sub, neg, add_scalar_bit, mask_bits, rshift_round, geq_const, select,
from_digits16) and the scheme engine's rescale composite rshift_round ->
mask_bits -> resize.  ops/limbs.py dispatches here for a CUDA tensor; its
plain_* functions serve the CPU.  Each entry is one launch, counted in
LAUNCHES.  The chains take a warp per row group (csrc/rowwarp.cuh): lane i
of a group holds limb i of its row, the carries of a row come from two
ballots, and a row of more than 32 limbs takes the warp 32 limbs at a
time; mask_bits and select take one thread a word or a pair of words.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "limbs.cu")

OPS = {"add": 0, "sub": 1, "neg": 2, "add_scalar_bit": 3, "mask_bits": 4, "rshift_round": 5,
       "rshift_round_mask": 6, "geq_const": 7, "select": 8, "from_digits16": 9}
LAUNCHES = cuda_build.counters({k: 0 for k in OPS})
_KIND = {torch.int64: 0, torch.float64: 1, torch.bool: 2}

_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = ([_I32, _I64, _I64, _I32, _I32, _I32, _I32, _VP]
             + [_VP, _I64, _I64, _I64, _I32] + [_VP, _I64, _I64, _I64]
             + [_VP, _I64, _I64, _I32, _VP])

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library():
    """Build (if the source changed) and load the library's entry point."""
    global _lib
    if _lib is None:
        fn = cuda_build.load(SOURCE).gpqhe_limbs
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _rows(x, shape: tuple) -> tuple[list, torch.Tensor]:
    """Pointer and strides (s1, s2, sk) of x broadcast to the limb shape
    [..., R2, K] (given with at least two axes)."""
    if x is None:
        return [None, 0, 0, 0], None
    if x.ndim < len(shape):
        x = x.reshape((1,) * (len(shape) - x.ndim) + tuple(x.shape))
    v, _, s1, s2, sk = cuda_build.strides3(x, shape)
    return [v.data_ptr(), s1, s2, sk], v


def launch(op: str, out_shape: tuple, k: int, a, b=None, bit=None, k_out: int = 0,
           t: int = 0, nbits: int = 0, digits: bool = False) -> torch.Tensor:
    """One launch of entry `op` over the rows of out_shape[:-1] (limb ops)
    or out_shape (geq_const): a and b are limb operands of k limbs (digits
    for from_digits16), bit a per-row operand.  Checks the operands (types,
    then one CUDA device) before anything is loaded; returns a new tensor."""
    if a.dtype not in ((torch.int64, torch.float64) if digits else (torch.int64,)):
        raise ValueError(f"limbs kernel {op} takes int64 limbs, got {a.dtype}")
    cuda_build.check_dtype(*(x for x in (b,) if x is not None))
    if bit is not None and bit.dtype not in (torch.bool, torch.int64):
        raise ValueError(f"limbs kernel {op} takes a bool or int64 row operand, got {bit.dtype}")
    rows = tuple(out_shape[:-1]) if op != "geq_const" else tuple(out_shape)
    shape3 = (1,) * max(0, 1 - len(rows)) + rows + (k,)
    R1 = math.prod(shape3[:-2])
    R2 = shape3[-2]
    if R1 * R2 * (k if op in ("mask_bits", "select") else 1) >= 1 << 31:
        raise ValueError(f"limbs kernel {op}: {R1 * R2} rows of {k} limbs, the kernel indexes "
                         f"fewer than 2^31 rows (words for mask_bits and select)")
    dev = a.device
    cuda_build.check_device(dev, *(x for x in (a, b, bit) if x is not None))
    aargs, av = _rows(a, shape3)
    bargs, bv = _rows(b, shape3)
    targs = [None, 0, 0, 0]
    if bit is not None:
        targs, tv = _rows(bit[..., None], shape3[:-1] + (1,))
        targs = targs[:3] + [_KIND[bit.dtype]]
    out = torch.empty(out_shape, dtype=torch.bool if op == "geq_const" else torch.int64,
                      device=dev)
    if out.numel():
        rc = load_library()(OPS[op], R1, R2, k, k_out or k, t, nbits, out.data_ptr(),
                            *aargs, _KIND[a.dtype], *bargs, *targs,
                            cuda_build.stream_of(dev))
        if rc != 0:
            raise RuntimeError(f"limbs kernel {op} failed to launch: cudaError {rc}")
        LAUNCHES[op] += 1
    return out


def binary(op: str, a, b) -> torch.Tensor:
    shape = cuda_build.broadcast_shape(a.shape, b.shape)
    return launch(op, shape, shape[-1], a, b)


def geq_const(a, c) -> torch.Tensor:
    shape = cuda_build.broadcast_shape(a.shape, c.shape)
    return launch("geq_const", shape[:-1], shape[-1], a, c)


def select(mask, a, b) -> torch.Tensor:
    shape = cuda_build.broadcast_shape(a.shape, b.shape, tuple(mask.shape) + (1,))
    return launch("select", shape, shape[-1], a, b, bit=mask)
