"""Hand-written single-word u32 CUDA NTT (csrc/ntt32.cu) for chains whose
primes are below 2^30, with its plan tables, launch counters and dispatch.

Replaces the TPU kernel gpqhe_tpu/ops/ntt_pallas32.py::_ntt32_kernel and its
wrapper ntt_pallas32: forward NTT, inverse NTT, and inverse scaled by
n^-1 * phat^-1, on a logp <= 29 chain.  The tables are standard-domain
twiddles with companions floor(z * 2^32 / p) (ntt_pallas32.py:241-242), u32
words held in int32 tensors.  Residues go in and come out as int64
[..., dim, n], like the u64 kernel's: the kernel narrows on load and widens
on store, so the Pallas wrapper's two cast passes have no counterpart.

Dispatch: a CPU tensor goes through the plain twin (ops/ntt.py), which is
the same Montgomery code for every chain; a CUDA tensor launches the kernel,
which raises if it cannot.  There is no route to the u64 kernel.
LAUNCHES32 counts kernel launches per entry.
"""

from __future__ import annotations

import os

import torch

from . import cuda_build, ntt_cuda
from .ntt_cuda import KernelTables, NttPlan, plain_intt, plain_ntt

LAUNCHES32 = {"fwd": 0, "inv": 0, "inv_scaled": 0}

SOURCE = os.path.join(cuda_build.CSRC, "ntt32.cu")

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES32:
        LAUNCHES32[k] = 0


def load_library():
    """Build (if the source changed) and load the kernel's entry point."""
    global _lib
    if _lib is None:
        _lib = ntt_cuda.bind(SOURCE, "gpqhe_ntt32")
    return _lib


def make_kernel_tables(pctx, device) -> KernelTables:
    return ntt_cuda.make_kernel_tables(pctx, device, word=32)


make_plan = ntt_cuda.make_plan      # the word size comes from the tables


def _launch(a: torch.Tensor, plan: NttPlan, inverse: bool, scaled: bool):
    return ntt_cuda.launch(load_library, 32, LAUNCHES32, a, plan, inverse, scaled)


def ntt(a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward NTT of [..., dim, n] residues < p < 2^30, bit-reversed order."""
    if a.device.type == "cpu":
        return plain_ntt(a, plan)
    return _launch(a, plan, inverse=False, scaled=False)


def intt(a: torch.Tensor, plan: NttPlan, scaled: bool = False) -> torch.Tensor:
    """Inverse NTT, times n^-1 (scaled=False) or n^-1 * phat^-1 (scaled=True)."""
    if a.device.type == "cpu":
        return plain_intt(a, plan, scaled)
    return _launch(a, plan, inverse=True, scaled=scaled)
