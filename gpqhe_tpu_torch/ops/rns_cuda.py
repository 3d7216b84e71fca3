"""Hand-written CUDA RNS decompose and CRT reconstruct (csrc/rns.cu on
csrc/mont.cuh and csrc/mma.cuh): bindings, launch counters and argument
checks.

Replaces, on CUDA tensors, the torch chains of ops/rns.py that XLA fuses
inside each jitted program of the JAX package: decompose_core
(gpqhe_tpu/ops/rns.py:110, with the signed form of the ring engine's
decompose: a row of fewer than MMA_MIN_LIMBS limbs by 32 x 64-bit integer
products, one of more by u8 products on the tensor cores against
decompose_table) and the two halves of reconstruct_core (gpqhe_tpu/ops/rns.py:200):
digit_sums (y -> the int64 digit sums of S = sum_d y_d phat_d and the S / P
estimate, the 16-bit digit split and the f64 digit matmul of the plain
version in one launch, u8 products on the tensor cores) and lift (digit
sums -> limbs).  ops/rns.py dispatches here for a CUDA tensor; its plain_*
functions serve the CPU.  LAUNCHES counts launches per entry (digit_sums
under "digit_split", the kernel's class in a trace).  The lift takes a warp
per row group (csrc/rowwarp.cuh), a row of more than 32 limbs the whole
warp, 32 limbs at a time, up to MAX_LIMBS (six chunks: the exact lift of
every key-switch basis of the n = 2^16 chain, 167 limbs at its widest).
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "rns.cu")
MAX_LIMBS = 192          # the lift's per-row limbs (csrc/rns.cu: MAX_CHUNKS of 32)
DEPTH = 128              # bytes of depth a chunk of digit_sums or decompose_mma walks (DS_DEPTH)
# K*: decompose takes the tensor cores for rows of this many limbs or more.
# Set from `python3 chip_smoke.py --phases build,kernels,kernels16`'s decompose
# rows of both routes and `python3 tools/rns_decompose_scale.py` on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md section 6): at K = 14 the integer units
# lead at 16 primes (6.46 against 8.60 us, n = 2^14) and trail at 24 (10.31
# against 8.90); at K = 28 the tensor cores lead at 31 and 47 primes (16.08
# against 26.72 us and 28.44 against 38.63, n = 2^15), at K = 55 by 2.3-2.5x.
# The tensor cores' time hardly grows with K within a chunk of 32 limbs, the
# integer units' by about 2% of theirs a limb, and over the product bases
# (dim about K + 2 primes) the two meet between K = 16 and 20.
MMA_MIN_LIMBS = 20
MMA_MAX_LIMBS = 8256     # past it a byte column's sum passes the kernel's s32

LAUNCHES = cuda_build.counters({"decompose": 0, "digit_split": 0, "lift": 0})

_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "gpqhe_rns_decompose": [_I64, _I64, _I32, _I64, _I64, _I32, _I32, _VP, _VP, _VP,
                            _VP, _I64, _VP, _I64, _I32, _VP],
    "gpqhe_rns_decompose_mma": [_I64, _I64, _I32, _I64, _I64, _I32, _I32, _I32, _VP, _VP, _VP,
                                _VP, _I64, _VP, _I64, _I32, _VP, _I32, _VP],
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


def takes_mma(k_limbs: int) -> bool:
    """Whether decompose takes the tensor cores for rows of k_limbs limbs."""
    return MMA_MIN_LIMBS <= k_limbs <= MMA_MAX_LIMBS


def const_bytes(pmax: int) -> int:
    """The bytes of a constant below pmax that decompose_mma multiplies: 8,
    or 4 where the primes fit 32 bits (the table's byte columns a prime)."""
    return 8 if pmax >> 32 else 4


def decomp_byte_table(primes, k_limbs: int) -> np.ndarray:
    """u8 [nb dim, depth]: row nb d + k, column j holds byte k of c_dj =
    2^(8 j) R mod p_d (R = 2^64) for the 4 k_limbs bytes of a row of k_limbs
    limbs, depth = 4 k_limbs rounded up to a chunk (DEPTH bytes), the rest
    zero; nb = const_bytes of the largest prime.

    Operand of decompose_mma's products: a row's bytes x_j against it give
    s_dk = sum_j x_j c_dj[k], and sum_k s_dk 2^(8 k) R^-1 mod p_d is the row
    mod p_d.  A column sums at most 4 K products below 2^16, so it is
    < 2^31 for K <= 8256 (exact in the kernel's s32)."""
    primes = [int(p) for p in primes]
    nb = const_bytes(max(primes))
    nj = 4 * k_limbs
    out = np.zeros((nb * len(primes), -(-nj // DEPTH) * DEPTH), dtype=np.uint8)
    for d, p in enumerate(primes):
        c, cs = pow(2, 64, p), []
        for _ in range(nj):
            cs.append(c)
            c = (c << 8) % p
        cb = np.array(cs, dtype="<u8").view(np.uint8).reshape(nj, 8)
        out[nb * d:nb * (d + 1), :nj] = cb[:, :nb].T
    return out


# the tables of decompose_mma by the weights tensor they serve (a ring's, a
# mesh shard's: each made once and kept), as (nb, table)
_TABLES = WeakIdKeyDictionary()


def decompose_table(weights, ps) -> tuple[int, torch.Tensor]:
    """(nb, decomp_byte_table) on the weights' device for the primes ps and
    the 2 J limbs the weights [dim, J] serve (a row of 2 J - 1 limbs reads
    its first 4 (2 J - 1) bytes of depth), made at the first call with these
    weights and kept beside them.  Making it reads the primes to the host,
    so the first call for a weights tensor comes before any CUDA graph
    capture, as the weights' own (ring.weights) do."""
    hit = _TABLES.get(weights)
    if hit is None:
        primes = ps.reshape(-1).cpu().numpy().view(np.uint64)
        table = decomp_byte_table(primes, 2 * weights.shape[-1])
        hit = _TABLES[weights] = (const_bytes(int(primes.max())),
                                  torch.from_numpy(table).to(weights.device))
    return hit


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
    """[..., n, K] limbs -> [..., dim, n] residues (see rns.plain_decompose):
    decompose_mma where takes_mma(K), else decompose_imad."""
    route = decompose_mma if takes_mma(a.shape[-1]) else decompose_imad
    return route(a, ps, pinv, weights, src_bits)


def _decompose_operands(a, ps, pinv, weights, src_bits):
    """The checked operands of a decompose: (x, S, n, K, ss, sn, dim, J, psd,
    pvd, out), x the limbs with unit stride along K (copied where they had
    another), out the residues' empty tensor."""
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
    out = torch.empty(lead + (dim, n), dtype=torch.int64, device=dev)
    return x, math.prod(lead), n, K, ss, sn, dim, J, psd, pvd, out


def decompose_imad(a, ps, pinv, weights, src_bits: int | None = None) -> torch.Tensor:
    """decompose by rns_decompose_kernel: 32 x 64-bit products on the
    integer units."""
    x, S, n, K, ss, sn, dim, J, psd, pvd, out = _decompose_operands(a, ps, pinv, weights,
                                                                     src_bits)
    if out.numel():
        _check(load_library().gpqhe_rns_decompose(
            S, n, K, ss, sn, dim, J, out.data_ptr(), x.data_ptr(), weights.data_ptr(),
            ps.data_ptr(), psd, pinv.data_ptr(), pvd, src_bits or 0,
            cuda_build.stream_of(a.device)), "decompose")
        LAUNCHES["decompose"] += 1
    return out


def decompose_mma(a, ps, pinv, weights, src_bits: int | None = None) -> torch.Tensor:
    """decompose by rns_decompose_kernel_mma: the rows' bytes against
    decompose_table by u8 products on the tensor cores."""
    x, S, n, K, ss, sn, dim, J, psd, pvd, out = _decompose_operands(a, ps, pinv, weights,
                                                                     src_bits)
    if K > MMA_MAX_LIMBS:
        raise ValueError(f"{K} limbs: the tensor cores' sums hold {MMA_MAX_LIMBS} at most")
    if out.numel():
        nb, table = decompose_table(weights, ps)
        _check(load_library().gpqhe_rns_decompose_mma(
            S, n, K, ss, sn, dim, J, nb, out.data_ptr(), x.data_ptr(), weights.data_ptr(),
            ps.data_ptr(), psd, pinv.data_ptr(), pvd, src_bits or 0, table.data_ptr(),
            table.shape[-1], cuda_build.stream_of(a.device)), "decompose_mma")
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
