"""Hand-written CUDA modular arithmetic (csrc/modmath.cu on csrc/mont.cuh):
bindings, launch counters and argument checks.

Replaces, on CUDA tensors, the torch chains of ops/modmath.py that XLA
fuses inside each jitted program of the JAX package (gpqhe_tpu/ops/
modmath.py: mont_mul 52, mulmod 58, addmod 98, submod 104), and the fused
products of the scheme engine (cross terms, key products, the hoisted
step's products and sums).  ops/modmath.py dispatches here for a CUDA
tensor; its plain_* functions serve the CPU.  Each entry is one launch, and
LAUNCHES counts them per entry.

Operands are [..., dim, n] residue stacks of u64 words in int64, broadcast
against each other as torch would; per-prime constants (p, pinv, r2) are
[dim, 1] (any shape that broadcasts to the operands along the prime axis
only).  Views are read in place through their strides (cuda_build.strides3).
The elementwise kernel's mulmod reduces once (Barrett) against a per-prime
table made once per basis (barrett_table); the fused entries take two
Montgomery products.  SHAPES counts the launches by shape class.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "modmath.cu")

LAUNCHES = cuda_build.counters({
    "mont_mul": 0, "to_mont": 0, "mulmod": 0, "addmod": 0, "submod": 0, "summod": 0,
    "cross_terms": 0, "key_products": 0, "mulmod_sum": 0})

# mulmod's Barrett constants by prime table (barrett_table)
_MU = {}

# launches by shape class: (entry, the launch's broadcast shape, multipliers
# of a sum), counted where LAUNCHES is
SHAPES = cuda_build.counters({})

OP = {"mont_mul": 0, "to_mont": 0, "mulmod": 1, "addmod": 2, "submod": 3}
SUM_PLAIN, SUM_PRODUCTS, SUM_PRODUCTS_TIMES = 0, 1, 2
EW_MAX_N = 1 << 30          # mm_ew_kernel indexes a row's words in 32 bits

_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_V3 = [_VP, _I64, _I64, _I64]             # an [A, dim, n] view
_V4 = [_VP, _I64, _I64, _I64, _I64]       # an [M, A, dim, n] view
_CONSTS = [_VP, _I64] * 3                 # p, pinv, r2 (ew: mu) with their prime strides
_ARGTYPES = {
    "gpqhe_modmath_ew": [_I32, _I64, _I64, _I64, _VP] + _V3 * 2 + _CONSTS + [_VP],
    "gpqhe_modmath_cross": [_I64, _I64, _I64, _VP] + _V4 + _CONSTS + [_VP],
    "gpqhe_modmath_keyprod": [_I64, _I64, _I64, _VP] + _V3 * 3 + _CONSTS + [_VP],
    "gpqhe_modmath_sum": [_I32, _I64, _I64, _I64, _I64, _VP] + _V4 * 4 + _CONSTS + [_VP],
}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.clear()


def _counted(entry: str, shape: tuple, nw: int = 0) -> None:
    LAUNCHES[entry] += 1
    key = (entry, shape, nw)
    SHAPES[key] = SHAPES.get(key, 0) + 1


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


def _consts(shape: tuple, *cs) -> list:
    """Pointer and prime stride of each per-prime constant (None: unused)."""
    out = []
    for c in cs:
        if c is None:
            out += [None, 0]
            continue
        if c.ndim == 2 and c.shape[1] == 1 and c.shape[0] == shape[-2] != 1:
            out += [c.data_ptr(), c.stride(0)]       # the usual [dim, 1]
            continue
        x = c.expand(shape)
        st = x.stride()
        if any(s and n != 1 for i, (s, n) in enumerate(zip(st, shape)) if i != len(st) - 2):
            raise ValueError(f"a per-prime constant of shape {tuple(c.shape)} varies along "
                             f"more than the prime axis of {shape}")
        out += [x.data_ptr(), st[-2] if shape[-2] != 1 else 0]
    return out


def _views(shape: tuple, lead: int, *xs) -> tuple[list, list]:
    """Views of the operands (None: unused) as pointer and strides; returns
    (ctypes arguments, tensors kept alive for the call)."""
    args, keep = [], []
    for x in xs:
        if x is None:
            args += [None] + [0] * (4 if lead else 3)
            continue
        v, sm, sa, sd, sk = cuda_build.strides3(x, shape, lead)
        keep.append(v)
        args += [v.data_ptr()] + ([sm] if lead else []) + [sa, sd, sk]
    return args, keep


def _checked(shape: tuple, lead: int, xs: tuple, cs: tuple) -> tuple[list, list, list]:
    """Check the operands (int64, then shapes, then one CUDA device) before
    anything is loaded; returns (view arguments, kept tensors, constant
    arguments) with shape[lead:] the constants' shape."""
    ts = [t for t in xs + cs if t is not None]
    cuda_build.check_dtype(*ts)
    cargs = _consts(shape[lead:], *cs)
    cuda_build.check_device(ts[0].device, *ts)
    args, keep = _views(shape, lead, *xs)
    return args, keep, cargs


def _grid(shape: tuple, lead: int) -> tuple[int, int, int]:
    A = 1
    for s in shape[lead:-2]:
        A *= s
    return A, shape[-2], shape[-1]


def _check(rc: int, entry: str) -> None:
    if rc != 0:
        raise RuntimeError(f"modmath kernel {entry} failed to launch: cudaError {rc}")


def barrett_table(p, stride: int, dim: int) -> torch.Tensor:
    """mulmod's per-prime constant mu = floor(2^(k+63) / p), k the bit length
    of p, for the dim primes of the table p, stride words apart along the
    prime axis (a contiguous [dim] on p's device): built once per basis from
    the primes' values (one copy to the host), then looked up by the
    primes' address, stride, count and device.  An entry holds p, so that
    its memory, and with it the key, stays its own while the entry lives;
    prime tables are constants, never written in place."""
    key = (p.data_ptr(), stride, dim, p.device)
    hit = _MU.get(key)
    if hit is None:
        primes = torch.as_strided(p, (dim,), (stride,), p.storage_offset())
        mu = [(1 << (q.bit_length() + 63)) // q for q in
              (int(v) for v in primes.cpu().numpy().view(np.uint64))]
        hit = _MU[key] = (p, torch.from_numpy(np.array(mu, dtype=np.uint64).view(np.int64))
                          .to(p.device))
    return hit[1]


def elementwise(entry: str, x, y, p, pinv=None, r2=None) -> torch.Tensor:
    """One of mont_mul, to_mont, mulmod, addmod, submod on [..., dim, n].
    mulmod takes residues x, y < p and reduces once (Barrett) against
    barrett_table(p); r2 is checked, not read.  mont_mul takes any u64 x
    against y < p."""
    shape = cuda_build.broadcast_shape(x.shape, y.shape, p.shape)
    if shape[-1] >= EW_MAX_N:
        raise ValueError(f"the elementwise kernel takes rows of fewer than {EW_MAX_N} words, "
                         f"got {shape[-1]}")
    args, keep, cargs = _checked(shape, 0, (x, y), (p, pinv, r2))
    if entry == "mulmod":
        cargs[4:6] = [barrett_table(p, cargs[1], shape[-2]).data_ptr(), 1]
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    if out.numel():
        _check(load_library().gpqhe_modmath_ew(
            OP[entry], *_grid(shape, 0), out.data_ptr(), *args, *cargs,
            cuda_build.stream_of(x.device)), entry)
        _counted(entry, shape)
    return out


def cross_terms(x, p, pinv, r2) -> torch.Tensor:
    """x = (x0, x1, y0, y1) stacked [4, ..., dim, n] -> [3, ..., dim, n]."""
    if x.ndim < 3 or x.shape[0] != 4:
        raise ValueError(f"cross_terms takes [4, ..., dim, n], got {tuple(x.shape)}")
    shape = cuda_build.broadcast_shape(x.shape, (1,) + tuple(p.shape))
    args, keep, cargs = _checked(shape, 1, (x,), (p, pinv, r2))
    out = torch.empty((3,) + shape[1:], dtype=torch.int64, device=x.device)
    if out.numel():
        _check(load_library().gpqhe_modmath_cross(
            *_grid(shape, 1), out.data_ptr(), *args, *cargs,
            cuda_build.stream_of(x.device)), "cross_terms")
        _counted("cross_terms", shape)
    return out


def key_products(x, e0, e1, p, pinv, r2) -> torch.Tensor:
    """(x e0, x e1) mod p stacked [2, ..., dim, n]."""
    shape = cuda_build.broadcast_shape(x.shape, e0.shape, e1.shape, p.shape)
    args, keep, cargs = _checked(shape, 0, (x, e0, e1), (p, pinv, r2))
    out = torch.empty((2,) + shape, dtype=torch.int64, device=x.device)
    if out.numel():
        _check(load_library().gpqhe_modmath_keyprod(
            *_grid(shape, 0), out.data_ptr(), *args, *cargs,
            cuda_build.stream_of(x.device)), "key_products")
        _counted("key_products", shape)
    return out


def sums(entry: str, x, y, ws, p, pinv, r2) -> torch.Tensor:
    """Sums mod p over the leading axis M: of x (y None), of x y (ws empty),
    or of (x y) w for each w of ws (at most two).  Returns [len(ws) or 1,
    ..., dim, n]."""
    if len(ws) > 2:
        raise ValueError("the CUDA sum takes at most two multipliers")
    shape = cuda_build.broadcast_shape(*(t.shape for t in (x, y, *ws) if t is not None),
                                       (1,) + tuple(p.shape))
    if len(shape) < 3:
        raise ValueError(f"a sum over the leading axis takes [M, ..., dim, n], got {shape}")
    w = tuple(ws) + (None,) * (2 - len(ws))
    args, keep, cargs = _checked(shape, 1, (x, y) + w, (p, pinv, r2))
    mode = SUM_PLAIN if y is None else SUM_PRODUCTS_TIMES if ws else SUM_PRODUCTS
    out = torch.empty((max(len(ws), 1),) + shape[1:], dtype=torch.int64, device=x.device)
    if out.numel():
        _check(load_library().gpqhe_modmath_sum(
            mode, shape[0], *_grid(shape, 1), out.data_ptr(), *args, *cargs,
            cuda_build.stream_of(x.device)), entry)
        _counted(entry, shape, len(ws))
    return out
