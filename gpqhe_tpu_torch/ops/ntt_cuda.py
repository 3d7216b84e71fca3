"""Hand-written CUDA NTT (csrc/ntt.cu) with its plan tables, launch counters,
the schedule of its two passes, and the dispatch between kernel and plain
twin.

Replaces the TPU kernel gpqhe_tpu/ops/ntt_pallas.py::_ntt_kernel and its
wrapper ntt_pallas: forward NTT, inverse NTT, and inverse scaled by
n^-1 * phat^-1 (the CRT reconstruct's fused first step).  The kernel takes
standard-domain twiddles with Shoup companions floor(z * 2^64 / p), as the
Pallas plan built them (ntt_pallas.py:418-426); here they are computed once
per ring for every prime of the chain, vectorised over numpy object arrays,
interleaved as [dimub, n, 2] words (z, companion) so that one load brings
both, and a dim-prime plan points at the first dim rows.

Dispatch: a CPU tensor goes through the plain twin (ops/ntt.py); a CUDA
tensor launches the kernel, which raises if it cannot.  There is no other
fallback.  LAUNCHES counts calls of the kernel's entry, one per transform.

The schedule (csrc/ntt_passes.cuh): n = n1 * n2 is transformed in a column
pass (n2 interleaved sequences of n1 elements) and a row pass (n1 contiguous
sequences of n2), each a kernel of many small blocks in which a thread holds
eight coefficients in registers through up to three butterfly stages between
exchanges in shared memory.  The index maps of that schedule (split, stage
groups, thread -> elements, stage -> twiddle index, shared-memory layout)
are the small functions below; the .cu follows them, and the CPU tests walk
them block by block and thread by thread (tests/torch_ntt_schedule.py) to
hold the schedule against the twin without a card.

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
from .rns import BasisArrays

LAUNCHES = {"fwd": 0, "inv": 0, "inv_scaled": 0}

LOGN_MIN, LOGN_MAX = 4, 16
_MAX_SLABS = ((1 << 31) - 1) // 64   # grid.x holds 2^31 - 1 blocks; a pass has at most 64 a slab

SOURCE = os.path.join(cuda_build.CSRC, "ntt.cu")
PRIME_BITS = 61               # the u64 kernel's lazy < 8p bounds

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind(source: str, symbol: str):
    """Build and load a kernel library; returns the entry point `symbol`,
    which takes (a_in, a_out, nslab, dim, logn, tw, primes, scale, scale_s,
    inverse, stream) and returns the cudaError of the launch."""
    fn = getattr(cuda_build.load(source), symbol)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, i64, i32, i32, vp, vp, vp, vp, i32, vp]
    fn.restype = i32
    return fn


def load_library():
    """Build (if the source changed) and load the kernel's entry point."""
    global _lib
    if _lib is None:
        _lib = bind(SOURCE, "gpqhe_ntt")
    return _lib


# ---------------------------------------------------------------------------
# the schedule: index maps that csrc/ntt_passes.cuh follows
# ---------------------------------------------------------------------------

ONE_PASS_MAX_LOGN = 8         # n <= 2^8: the row pass alone (n1 = 1)
GROUP_LOG = 3                 # a thread holds 2^3 coefficients
PASS_LOG_MIN, PASS_LOG_MAX = 4, 8


def split_logn(logn: int) -> tuple[int, int]:
    """log2 of (n1, n2): n = n1 * n2, index i = r * n2 + c."""
    if logn <= ONE_PASS_MAX_LOGN:
        return 0, logn
    return (logn + 1) // 2, logn // 2


def stage_groups(L: int) -> tuple[int, ...]:
    """Widths of the register groups of a 2^L pass, top stages first:
    4 = 2+2, 5 = 3+2, 6 = 3+3, 7 = 3+2+2, 8 = 3+3+2."""
    ng = -(-L // GROUP_LOG)
    return tuple(L // ng + (g < L % ng) for g in range(ng))


def group_windows(L: int, groups=None) -> list[tuple[int, int, int]]:
    """Per register group, top stages first: (lo, width, a).  The group runs
    stages loglen = lo .. lo+width-1 on the 8 elements whose index differs
    in bits a .. a+2 (a = min(lo, L-3): the window never leaves the pass)."""
    groups = stage_groups(L) if groups is None else tuple(groups)
    if sum(groups) != L or not all(1 <= w <= GROUP_LOG for w in groups):
        raise ValueError(f"stage groups {groups} do not cover a 2^{L} pass")
    out, lo = [], L
    for w in groups:
        lo -= w
        out.append((lo, w, min(lo, L - GROUP_LOG)))
    return out


def element_index(t, e, a: int):
    """Index in its sequence of register e (0..7) of thread t (0..m/8-1)
    while the window is at bit a: bits a..a+2 are e, the rest are t."""
    return ((t >> a) << (a + GROUP_LOG)) | (e << a) | (t & ((1 << a) - 1))


def twiddle_index(base, L: int, a: int, b: int, t, e0: int):
    """Row index of the (z, companion) pair of the butterfly of registers
    (e0, e0 | 1 << b) of thread t in the stage loglen = a + b of a 2^L pass.
    base is 1 for the column pass and for a one-pass transform, n1 + r for
    row r of the row pass (the sub-block indexing n/(2 len) + r n2/(2 len) +
    k of the bit-reversed table)."""
    return (base << (L - 1 - a - b)) + ((t >> a) << (GROUP_LOG - 1 - b)) + (e0 >> (b + 1))


def row_smem_index(s, idx, L: int):
    """Row pass: word of sequence s, element idx, one pad word per 8 so that
    neither the stride-8 nor the stride-1 side of an exchange piles on a bank."""
    return s * ((1 << L) + (1 << (L - GROUP_LOG))) + idx + (idx >> GROUP_LOG)


def col_smem_index(j, idx, C: int):
    """Column pass: column j fastest, so a warp's lanes (neighbouring columns
    of one row) hit neighbouring words on both sides of an exchange."""
    return idx * C + j


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
    """Twiddle tables of every prime of a ring's chain, rows in chain order:
    [dimub, n, 2] words, [..., 0] the standard-domain twiddle in bit-reversed
    order and [..., 1] its Shoup companion (u64 bit patterns in int64 for
    the u64 kernel, u32 in int32 for the u32 kernel)."""
    word: int
    primes: torch.Tensor
    tw_f: torch.Tensor
    tw_i: torch.Tensor


def kernel_tables(primes, zetas, zetas_inv, device, word: int = 64) -> KernelTables:
    """Kernel tables of the given primes from their Montgomery-domain
    bit-reversed twiddle tables (u64 host arrays [dim, n], one row a prime)."""
    bits = PRIME_BITS if word == 64 else 30
    if max(primes) >= 1 << bits:
        raise ValueError(f"the u{word} CUDA NTT's lazy bounds need primes < 2^{bits}")

    def pairs(table):
        # np.stack copies into a fresh C-ordered array: the kernel reads
        # the pairs through a bare pointer
        return words_to_torch(np.stack([np.stack(std_and_shoup(row, p, word), axis=-1)
                                        for row, p in zip(table, primes)]), word, device)
    return KernelTables(
        word=word,
        primes=words_to_torch(np.array(primes, dtype=np.uint64), word, device),
        tw_f=pairs(zetas), tw_i=pairs(zetas_inv))


def make_kernel_tables(pctx, device, word: int = 64) -> KernelTables:
    return kernel_tables(pctx.primes, [pc.zetas for pc in pctx.prime_ctx],
                         [pc.zetas_inv for pc in pctx.prime_ctx], device, word)


def scale_words(primes, n: int, word: int, device, phat_invmp=None) -> torch.Tensor:
    """[2, dim] words: n^-1 mod p (times phat^-1 where phat_invmp is given)
    and its Shoup companion, the inverse transform's final multiplier."""
    rows = []
    for d, p in enumerate(primes):
        s = pow(n, -1, p)
        if phat_invmp is not None:
            s = s * phat_invmp[d] % p
        rows.append((s, (s << word) // p))
    return words_to_torch(np.ascontiguousarray(np.array(rows, dtype=np.uint64).T),
                          word, device)


@dataclass(frozen=True)
class NttPlan:
    """One dim-prime basis: the twin's Montgomery tables (from BasisArrays)
    and, for a CUDA ring, the kernel's tables and scale constants.  The
    kernel reads the tables through bare pointers, so their shapes, types
    and contiguity are checked here, once, when the plan is made."""
    dim: int
    n: int
    ba: object                       # rns.BasisArrays
    tables: KernelTables | None
    scale: torch.Tensor | None       # [2, dim] words: n^-1 and its Shoup companion
    scale_phat: torch.Tensor | None  # [2, dim] words: n^-1 phat^-1 and companion;
    #                                  None on a plan that has no scaled inverse

    def __post_init__(self):
        t = self.tables
        if t is None:
            return
        dtype = torch.int64 if t.word == 64 else torch.int32
        for name, x in (("tw_f", t.tw_f), ("tw_i", t.tw_i)):
            if (x.ndim != 3 or x.shape[0] < self.dim or tuple(x.shape[1:]) != (self.n, 2)
                    or x.shape[0] != t.primes.shape[0]):
                raise ValueError(f"NTT table {name} has shape {tuple(x.shape)}, the kernel "
                                 f"takes [>= {self.dim}, {self.n}, 2] interleaved pairs")
        scales = [(name, x) for name, x in (("scale", self.scale),
                                            ("scale_phat", self.scale_phat)) if x is not None]
        for name, x in scales:
            if tuple(x.shape) != (2, self.dim):
                raise ValueError(f"NTT {name} has shape {tuple(x.shape)}, not (2, {self.dim})")
        for x in [t.tw_f, t.tw_i, t.primes] + [x for _, x in scales]:
            if x.dtype != dtype or x.device != t.primes.device:
                raise ValueError(f"the u{t.word} NTT kernel's tables must be {dtype} on one device")
            if not x.is_contiguous():
                raise ValueError("the NTT kernel's tables must be contiguous")


def make_plan(pctx, dim: int, ba, tables: KernelTables | None) -> NttPlan:
    if tables is None:
        return NttPlan(dim, pctx.n, ba, None, None, None)
    b = pctx.basis(dim)
    word, dev = tables.word, tables.primes.device
    return NttPlan(dim, pctx.n, ba, tables, scale_words(b.primes, pctx.n, word, dev),
                   scale_words(b.primes, pctx.n, word, dev, b.phat_invmp))


class ShardTables:
    """Tables of one shard of a coefficient-sharded transform (parallel/
    mesh.py), for every prime of the chain, on one device.  The shard's
    local stages are the unmodified transforms at length L = n/S over
    tables laid out like the chain's own (rows 1..L-1 of a bit-reversed
    table), so they take an ordinary plan; only the inverse's scale is the
    ring's n^-1, not L^-1, and there is no n^-1 phat^-1 form.

    zetas, zetas_inv: the shard's Montgomery-domain tables, u64 host arrays
    [dimub, L].  A CUDA device gets the kernel's tables beside the twin's
    and needs L >= 2^LOGN_MIN; the twin on the CPU has no such limit."""

    def __init__(self, pctx, zetas: np.ndarray, zetas_inv: np.ndarray, device, word: int):
        self.length = zetas.shape[-1]
        device = torch.device(device)
        pcs = pctx.prime_ctx
        self.ps = u64_to_torch(np.array(pctx.primes, dtype=np.uint64), device)
        self.pinv = u64_to_torch(np.array([pc.pinv_mont for pc in pcs], dtype=np.uint64), device)
        self.ninv_mont = u64_to_torch(np.array([pc.ninv_mont for pc in pcs], dtype=np.uint64),
                                      device)
        self.zetas = u64_to_torch(zetas, device)
        self.zetas_inv = u64_to_torch(zetas_inv, device)
        self.kernel = self.scale = None
        if device.type == "cuda":
            if self.length < 1 << LOGN_MIN:
                raise ValueError(
                    f"a coefficient shard of {self.length} coefficients is below the CUDA "
                    f"NTT's n = 2^{LOGN_MIN}: use fewer coefficient shards on this ring")
            self.kernel = kernel_tables(pctx.primes, zetas, zetas_inv, device, word)
            self.scale = scale_words(pctx.primes, pctx.n, word, device)

    def plan(self, r0: int, r1: int) -> NttPlan:
        """The plan of primes r0..r1-1 of the chain (a limb shard's rows):
        views of the chain-wide tables, which are contiguous row by row."""
        ba = BasisArrays(dim=r1 - r0, ps=self.ps[r0:r1], pinv=self.pinv[r0:r1],
                         ninv_mont=self.ninv_mont[r0:r1], r2=None, phatinv_mont=None,
                      ninvphat_mont=None, zetas=self.zetas[r0:r1],
                      zetas_inv=self.zetas_inv[r0:r1])
        if self.kernel is None:
            return NttPlan(r1 - r0, self.length, ba, None, None, None)
        k = self.kernel
        tables = KernelTables(k.word, k.primes[r0:r1], k.tw_f[r0:r1], k.tw_i[r0:r1])
        return NttPlan(r1 - r0, self.length, ba, tables,
                       self.scale[:, r0:r1].contiguous(), None)


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
    """One transform of int64 residues through the entry point that loader()
    returns (see bind); adds one to the entry's counter."""
    logn, nslab = check_args(a, plan)
    t = plan.tables
    if t.word != word:
        raise ValueError(f"NTT plan holds u{t.word} tables, the kernel takes u{word}")
    a = a.contiguous()
    if a.data_ptr() % 16:          # the row pass loads 16 bytes a thread
        a = a.clone()
    out = torch.empty_like(a)
    if nslab == 0:
        return out
    sc = plan.scale_phat if scaled else plan.scale
    if sc is None:
        raise ValueError("this NTT plan has no n^-1 phat^-1 scale: no scaled inverse")
    rc = loader()(a.data_ptr(), out.data_ptr(), nslab, plan.dim, logn,
                  (t.tw_i if inverse else t.tw_f).data_ptr(), t.primes.data_ptr(),
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
    if scaled and ba.ninvphat_mont is None:
        raise ValueError("this NTT plan has no n^-1 phat^-1 scale: no scaled inverse")
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
