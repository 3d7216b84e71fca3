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

The library is built at first use by ops/cuda_build.py and loaded with
ctypes.  The plan-table builders, the argument check and the launch are
shared with the u32 kernel's binding (ops/ntt_cuda32.py): word = 64 here,
32 there.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build
from . import ntt as twin
from .modmath import u64_to_torch

LAUNCHES = {"fwd": 0, "inv": 0, "inv_scaled": 0}

LOGN_MIN, LOGN_MAX = 4, 16
_MAX_SLABS = 65535            # grid.y of the global-memory stage pass

SOURCE = os.path.join(cuda_build.CSRC, "ntt.cu")
PRIME_BITS = 61               # the u64 kernel's lazy < 8p bounds

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind(source: str, symbol: str):
    """Build and load a kernel library; returns its entry point, which takes
    (a_in, a_out, nslab, dim, logn, tw, tws, primes, scale, scale_s,
    inverse, stream) and returns the cudaError of the launch."""
    fn = getattr(cuda_build.load(source), symbol)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, i64, i32, i32, vp, vp, vp, vp, vp, i32, vp]
    fn.restype = i32
    return fn


def load_library():
    """Build (if the source changed) and load the kernel's entry point."""
    global _lib
    if _lib is None:
        _lib = bind(SOURCE, "gpqhe_ntt")
    return _lib


# ---------------------------------------------------------------------------
# plan tables
# ---------------------------------------------------------------------------

def std_and_shoup(zmont: np.ndarray, p: int, word: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Montgomery-domain table (z*R mod p, R = 2^64) -> (standard-domain z,
    Shoup companions floor(z * 2^word / p)), both u64, exact in Python ints."""
    rinv = pow(1 << 64, -1, p)
    z = (np.asarray(zmont, dtype=np.uint64).astype(object) * rinv) % p
    return z.astype(np.uint64), ((z << word) // p).astype(np.uint64)


def words_to_torch(a: np.ndarray, word: int, device) -> torch.Tensor:
    """u64 host array of values < 2^word -> int64 (word=64) or int32
    (word=32) tensor holding the same bit patterns."""
    if word == 64:
        return u64_to_torch(a, device)
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


@dataclass(frozen=True)
class KernelTables:
    """Twiddle tables of every prime of a ring's chain: [dimub, n] words
    (u64 bit patterns in int64 for the u64 kernel, u32 in int32 for the u32
    kernel), rows in chain order."""
    word: int
    primes: torch.Tensor
    tw_f: torch.Tensor
    tws_f: torch.Tensor
    tw_i: torch.Tensor
    tws_i: torch.Tensor


def make_kernel_tables(pctx, device, word: int = 64) -> KernelTables:
    bits = PRIME_BITS if word == 64 else 30
    if max(pctx.primes) >= 1 << bits:
        raise ValueError(f"the u{word} CUDA NTT's lazy bounds need primes < 2^{bits}")
    rows = {"tw_f": [], "tws_f": [], "tw_i": [], "tws_i": []}
    for pc in pctx.prime_ctx:
        for key, table in (("f", pc.zetas), ("i", pc.zetas_inv)):
            z, zs = std_and_shoup(table, pc.p, word)
            rows["tw_" + key].append(z)
            rows["tws_" + key].append(zs)
    return KernelTables(
        word=word,
        primes=words_to_torch(np.array(pctx.primes, dtype=np.uint64), word, device),
        **{k: words_to_torch(np.stack(v), word, device) for k, v in rows.items()})


@dataclass(frozen=True)
class NttPlan:
    """One dim-prime basis: the twin's Montgomery tables (from BasisArrays)
    and, for a CUDA ring, the kernel's tables and scale constants."""
    dim: int
    n: int
    ba: object                       # rns.BasisArrays
    tables: KernelTables | None
    scale: torch.Tensor | None       # [2, dim] words: n^-1 and its Shoup companion
    scale_phat: torch.Tensor | None  # [2, dim] words: n^-1 phat^-1 and companion


def make_plan(pctx, dim: int, ba, tables: KernelTables | None) -> NttPlan:
    if tables is None:
        return NttPlan(dim, pctx.n, ba, None, None, None)
    b = pctx.basis(dim)
    word = tables.word
    rows = {"n": [], "np": []}
    for d, p in enumerate(b.primes):
        ninv = pow(pctx.n, -1, p)
        for key, s in (("n", ninv), ("np", ninv * b.phat_invmp[d] % p)):
            rows[key].append((s, (s << word) // p))
    dev = tables.primes.device

    def t(vals):
        return words_to_torch(np.array(vals, dtype=np.uint64).T, word, dev)
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


def launch(loader, word: int, counters: dict, a: torch.Tensor, plan: NttPlan,
           inverse: bool, scaled: bool) -> torch.Tensor:
    """One kernel launch on int64 residues through the entry point that
    loader() returns (see bind); adds one to the entry's counter."""
    logn, nslab = check_args(a, plan)
    if plan.tables.word != word:
        raise ValueError(f"NTT plan holds u{plan.tables.word} tables, the kernel takes u{word}")
    a = a.contiguous()
    out = torch.empty_like(a)
    if nslab == 0:
        return out
    t = plan.tables
    tw, tws = (t.tw_i, t.tws_i) if inverse else (t.tw_f, t.tws_f)
    sc = plan.scale_phat if scaled else plan.scale
    if not all(x.is_contiguous() for x in (tw, tws, t.primes, sc[0], sc[1])):
        raise ValueError("the NTT kernel's tables must be contiguous")
    rc = loader()(a.data_ptr(), out.data_ptr(), nslab, plan.dim, logn,
                  tw.data_ptr(), tws.data_ptr(), t.primes.data_ptr(),
                  sc[0].data_ptr(), sc[1].data_ptr(), int(inverse),
                  torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"NTT kernel launch failed: cudaError {rc}")
    counters["inv_scaled" if scaled else "inv" if inverse else "fwd"] += 1
    return out


def _launch(a: torch.Tensor, plan: NttPlan, inverse: bool, scaled: bool):
    return launch(load_library, 64, LAUNCHES, a, plan, inverse, scaled)


def plain_ntt(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """The plain twin on the plan's Montgomery tables."""
    ba = plan.ba
    return twin.ntt(a, ba.zetas, ba.ps, ba.pinv)


def plain_intt(a: torch.Tensor, plan: NttPlan, scaled: bool = False) -> torch.Tensor:
    ba = plan.ba
    return twin.intt(a, ba.zetas_inv, ba.ps, ba.pinv,
                     ba.ninvphat_mont if scaled else ba.ninv_mont)


def ntt(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward NTT of [..., dim, n] residues < p, bit-reversed order."""
    if a.device.type == "cpu":
        return plain_ntt(a, plan)
    return _launch(a, plan, inverse=False, scaled=False)


def intt(a: torch.Tensor, plan: NttPlan, scaled: bool = False) -> torch.Tensor:
    """Inverse NTT, times n^-1 (scaled=False) or n^-1 * phat^-1 (scaled=True)."""
    if a.device.type == "cpu":
        return plain_intt(a, plan, scaled)
    return _launch(a, plan, inverse=True, scaled=scaled)
