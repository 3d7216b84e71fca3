"""Hand-written CUDA RNS decompose and CRT reconstruct (csrc/rns.cu on
csrc/mont.cuh and csrc/mma.cuh): bindings, launch counters and argument
checks.

Replaces, on CUDA tensors, the torch chains of ops/rns.py that XLA fuses
inside each jitted program of the JAX package: decompose_core
(gpqhe_tpu/ops/rns.py:110, with the signed form of the ring engine's
decompose) and the two halves of reconstruct_core (gpqhe_tpu/ops/rns.py:200):
digit_sums (y -> the int64 digit sums of S = sum_d y_d phat_d and the S / P
estimate, the 16-bit digit split and the f64 digit matmul of the plain
version in one launch, u8 products on the tensor cores) and lift (digit
sums -> limbs).  ops/rns.py dispatches here for a CUDA tensor; its plain_*
functions serve the CPU.  LAUNCHES counts launches per entry (digit_sums
under "digit_split", the kernel's class in a trace).  The lift takes a warp
per row group (csrc/rowwarp.cuh), a row of more than 32 limbs the whole
warp, 32 limbs at a time.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "rns.cu")
MAX_LIMBS = 128          # the lift's per-row limbs (csrc/rns.cu)
DEPTH = 128              # bytes of depth a chunk of digit_sums walks (csrc/rns.cu DS_DEPTH)

LAUNCHES = cuda_build.counters({"decompose": 0, "digit_split": 0, "lift": 0})

_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "gpqhe_rns_decompose": [_I64, _I64, _I32, _I64, _I64, _I32, _I32, _VP, _VP, _VP,
                            _VP, _I64, _VP, _I64, _I32, _VP],
    "gpqhe_rns_digit_sums": [_I64, _I32, _I64, _I32, _I32, _VP, _VP, _VP, _I64, _I64, _I64,
                             _VP, _I64, _VP, _I64, _VP, _I64, _VP, _I64, _VP, _I32, _VP],
    "gpqhe_rns_lift": [_I64, _I32, _VP, _VP, _I32, _VP, _I32, _I32, _I32,
                       _VP, _VP, _VP, _VP, _VP],
}

_lib = None


def residue_bytes(nd: int) -> int:
    """The bytes a residue of nd 16-bit digits takes in digit_sums' product:
    8, or 4 where the primes fit 32 bits (the kernel copies 4 or 8)."""
    return 8 if nd > 2 else 4


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
        raise RuntimeError(f"rns kernel {entry} failed to launch: cudaError {rc}")


def _prime_vector(x: torch.Tensor, dim: int, name: str) -> int:
    """Stride of a per-prime vector ([dim] or [dim, 1]) along its primes."""
    if x.numel() != dim:
        raise ValueError(f"{name} has {x.numel()} entries for {dim} primes")
    if x.ndim == 1 or (x.ndim == 2 and x.shape[1] == 1):
        return x.stride(0)
    return x.reshape(dim).stride(0)


def _contiguous_table(x: torch.Tensor, shape: tuple, name: str) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, the kernel takes {shape}")
    if not x.is_contiguous():
        raise ValueError(f"the kernel reads {name} through a bare pointer: it must be contiguous")


def decompose(a, ps, pinv, weights, src_bits: int | None = None) -> torch.Tensor:
    """[..., n, K] limbs -> [..., dim, n] residues (see rns.plain_decompose)."""
    dev = a.device
    K = a.shape[-1]
    dim = ps.numel()
    J = (K + 1) // 2
    cuda_build.check_dtype(a, ps, pinv, weights)
    _contiguous_table(weights, (dim, J), "the decompose weights")
    psd, pvd = _prime_vector(ps, dim, "ps"), _prime_vector(pinv, dim, "pinv")
    if src_bits is not None and not 0 < src_bits <= 32 * K:
        raise ValueError(f"src_bits {src_bits} outside 1..{32 * K}")
    if a.ndim < 2:
        raise ValueError(f"decompose takes [..., n, K] limbs, got {tuple(a.shape)}")
    cuda_build.check_device(dev, a, ps, pinv, weights)
    lead = tuple(a.shape[:-2])
    n = a.shape[-2]
    x, _, ss, sn, sk = cuda_build.strides3(a, tuple(a.shape))
    if sk != 1:
        x = a.contiguous()
        cuda_build.COPIES["operands"] += 1
        _, _, ss, sn, sk = cuda_build.strides3(x, tuple(a.shape))
    S = math.prod(lead)
    out = torch.empty(lead + (dim, n), dtype=torch.int64, device=dev)
    if out.numel():
        _check(load_library().gpqhe_rns_decompose(
            S, n, K, ss, sn, dim, J, out.data_ptr(), x.data_ptr(), weights.data_ptr(),
            ps.data_ptr(), psd, pinv.data_ptr(), pvd, src_bits or 0,
            cuda_build.stream_of(dev)), "decompose")
        LAUNCHES["decompose"] += 1
    return out


def digit_sums(y, plan, kd: int, scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., dim, n] residues -> (digit sums int64 [..., n, kd] of S = sum_d
    y_d phat_d, af f64 [..., n] = sum_d y_d / p_d) over the primes whose rows
    plan.phat_bytes and plan.inv_p hold; scale = (phatinv_mont, ps, pinv)
    first multiplies y_d by phatinv_d in Montgomery form.  The digit sums
    are not plain_digit_partials' column by column: sum_j S16_j 2^(16 j) is
    S mod 2^(16 kd), which is all the lift reads."""
    dev = y.device
    if y.ndim < 2:
        raise ValueError(f"digit_sums takes [..., dim, n] residues, got {tuple(y.shape)}")
    dim, n = y.shape[-2], y.shape[-1]
    nb = residue_bytes(plan.nd)
    cuda_build.check_dtype(y, *(scale or ()))
    cuda_build.check_dtype(plan.inv_p, dtype=torch.float64)
    ipd = _prime_vector(plan.inv_p, dim, "inv_p")
    table = plan.phat_bytes
    depth = table.shape[-1]
    if (table.dtype != torch.uint8 or tuple(table.shape) != (2 * plan.ds, depth)
            or depth % DEPTH or depth < nb * dim or not table.is_contiguous()
            or table.data_ptr() % 16):
        raise ValueError(f"the phat byte table must be contiguous, 16-byte aligned u8 "
                         f"[{2 * plan.ds}, a multiple of {DEPTH} >= {nb * dim}], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if not 1 <= kd <= plan.ds:
        raise ValueError(f"{kd} digit sums: the plan has {plan.ds}")
    sargs = [None, 0, None, 0, None, 0]
    if scale is not None:
        sargs = [a for t, name in zip(scale, ("phatinv", "ps", "pinv"))
                 for a in (t.data_ptr(), _prime_vector(t, dim, name))]
    cuda_build.check_device(dev, y, plan.inv_p, table, *(scale or ()))
    v, _, ys, yd, yk = cuda_build.strides3(y, tuple(y.shape))
    lead = tuple(y.shape[:-2])
    S = math.prod(lead)
    sums = torch.empty(lead + (n, kd), dtype=torch.int64, device=dev)
    af = torch.empty(lead + (n,), dtype=torch.float64, device=dev)
    if af.numel():
        _check(load_library().gpqhe_rns_digit_sums(
            S, dim, n, nb, kd, sums.data_ptr(), af.data_ptr(), v.data_ptr(), ys, yd, yk,
            *sargs, plan.inv_p.data_ptr(), ipd, table.data_ptr(), depth,
            cuda_build.stream_of(dev)), "digit_sums")
        LAUNCHES["digit_split"] += 1
    return sums, af


def lift(s_digits, af, plan, center: bool, k_out: int | None) -> torch.Tensor:
    """int64 digit sums [..., n, kd] (digit_sums') and af [..., n] -> limbs
    [..., n, k_out] (fast path) or [..., n, plan.ks] (exact, k_out None)."""
    dev = s_digits.device
    if s_digits.dtype != torch.int64:
        raise ValueError(f"the lift takes int64 digit sums, got {s_digits.dtype}")
    cuda_build.check_dtype(af, dtype=torch.float64)
    ks = plan.ks
    tables = {"negP16": plan.negP16, "P_limbs": plan.P_limbs,
              "Phalf_limbs": plan.Phalf_limbs, "MminusP_limbs": plan.MminusP_limbs}
    cuda_build.check_dtype(*tables.values())
    for name, t in tables.items():
        _contiguous_table(t, (plan.ds if name == "negP16" else ks,), name)
    kd = s_digits.shape[-1]
    exact = k_out is None
    kout = ks if exact else k_out
    if not 1 <= kout <= min(ks, MAX_LIMBS) or kd > plan.ds:
        raise ValueError(f"lift to {kout} limbs from {kd} digits: the plan has {ks} limbs "
                         f"and {plan.ds} digits, the kernel at most {MAX_LIMBS} limbs")
    if tuple(af.shape) != tuple(s_digits.shape[:-1]):
        raise ValueError(f"af {tuple(af.shape)} against digit sums {tuple(s_digits.shape)}")
    cuda_build.check_device(dev, af, *tables.values())
    sd = s_digits.contiguous()
    afc = af.contiguous()
    R = afc.numel()
    out = torch.empty(tuple(af.shape) + (kout,), dtype=torch.int64, device=dev)
    if R:
        _check(load_library().gpqhe_rns_lift(
            R, kd, sd.data_ptr(), afc.data_ptr(), plan.dim,
            plan.negP16.data_ptr(), kout, int(exact), int(center), plan.P_limbs.data_ptr(),
            plan.Phalf_limbs.data_ptr(), plan.MminusP_limbs.data_ptr(), out.data_ptr(),
            cuda_build.stream_of(dev)), "lift")
        LAUNCHES["lift"] += 1
    return out
