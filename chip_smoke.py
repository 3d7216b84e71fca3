#!/usr/bin/env python3
"""Kernel bench of the PyTorch/CUDA port (gpqhe_tpu_torch) on one GPU: each
hand-written kernel against its plain torch version, timed, with its bound.

Run from the repository root:  python3 chip_smoke.py [--phases a,b] [--iters N]

The ops end to end are measured by gpubench/ (BENCHMARK.json's cells) and
held on the card by tests/test_torch_cuda.py; the cases here and there are
tests/torch_cases.py's.  Phases, each printing JSON lines; any failure
raises and the script exits non-zero:
  build    — compile the six CUDA sources (csrc/ntt.cu, ntt32.cu, the
             elementwise kernels modmath.cu, rns.cu, limbs.cu, and the
             four-step NTT's ntt4.cu) with nvcc (sm_90a), one process each,
             started together, and load them;
             the card's name and power limit from nvidia-smi; per kernel
             instantiation ptxas's registers, spills, stack and shared
             memory where this run built the source; for every K7, lift,
             decompose, digit-product, K5 (modmath.cu) and K8 (ntt4.cu)
             instantiation in the libraries as loaded (`row_kernels`),
             cuobjdump's registers, stack, shared and local memory, and a
             raise on any stack frame or local memory; static
             multiply-instruction and tensor-core-product (IMMA, HGMMA)
             counts from cuobjdump, and a raise where a K8 or a digit-
             product (rns.cu) instantiation has no tensor-core product.
  kernels  — each CUDA NTT (u64 words on the 59-bit chain, u32 words on the
             logp=29 chain) against the plain torch twin on the card:
             torch.equal on random residues at the paths' shapes (CASES);
             the device time per launch in two turns, each a run of many
             launches between one pair of CUDA events with the host
             enqueueing ahead of the device, inputs L2-warm; the wrapper's
             host time per call; the twin's median; the bound.  The same at
             the bootstrap ring's shapes (logn=15, bootstrap_cases: kernel
             `ntt15` on `kernels15` lines) and for the u32 kernel on
             tests/test_crt_mode.py's logp=9 chain (`ntt32p9`, [3, 16]).
             Then every entry of the elementwise kernels (K5 modmath, K4
             decompose, K6 the CRT reconstruct, K7 limbs) torch.equal to its
             plain torch version on edge words at the shapes the paths give
             it (logn=14 on both chains, logn=15; batch 8; the reconstruct
             end to end at its bounds), the first shape of each timed as
             the NTT is, and for select and mask_bits one PyTorch call of
             the same function timed the same way and the ratio
             (`ms_over_library`); K7 and the lift timed at logn=15 too, on
             `kernels15` lines, and decompose, the digit product and every
             K5 entry at the bootstrap's shapes there (retimed15; K5 at the
             shape classes the bootstrap launches most, BOOT15_K5); the
             rows wider than a warp timed at both (`wide`: the exact lift at
             the key switch's basis, geq_const at 62 and 125 limbs); then
             K7, the lift, decompose, the digit product and K5's elementwise
             entries at the edges of their designs (elementwise_edge_cases),
             each torch.equal to its plain version.
  kernels16 — the logn=16 ring of gpubench's ckks-n16-q1751 (58 levels):
             the u64 NTT forward, inverse and scaled inverse at [4, 60, 2^16]
             and [2, 90, 2^16] against its twin (NTT16), then decompose into
             60 and 90 primes, the digit product (DIGITS16), the lift at
             the widths a key switch there takes (LIFT16: past four
             chunks of 32, 147 limbs at level 37 and the widest basis's
             167) and ecd's fill
             (ring16_cases), each torch.equal to its plain version and timed
             as in kernels.
  ntt4     — K8, the four-step ("matmul") NTT's stage (csrc/ntt4.cu: one
             launch a stage, u8 digit planes on the tensor cores), against
             its plain version (split, f64 torch.bmm, combine) on the card:
             at the path's shapes on both chains every stage and the whole
             transform torch.equal, and the round trip; each shape timed
             (each stage's device ms, host us, plain ms, the f64 torch.bmm
             of the plain version's planes alone as library_ms, the bound
             and the shares of its int8-operation and byte bounds; the whole
             transform beside the butterfly kernel's at the same shape, with
             its own bound); at the edges (every logn 4-16, batches of 1 and
             8, words all 0 or all p - 1, the logp=9 chain) and at a stage's
             largest digit sums (K = 256, every byte 255, P8 = 2, 4, 8).
  mesh     — the NTT kernels on the mesh programs' per-shard plans (a
             virtual mesh naming the one card several times, or distinct
             GPUs where torch.cuda.device_count() covers it): both word
             sizes at logn=14 on (2,2,2) (n/S = 2^13, the shapes mul_rs
             launches there; `nttmesh`, `ntt32mesh`) and (2,4,2) (2^12), and
             the u64 kernel at logn=15 on (2,4,1) (coeff2slot's key switch,
             `ntt15mesh`), each coefficient shard torch.equal to the twin on
             the same local tables, the last one timed with its bound.
Then the nvidia-smi line, the per-kernel JSON line (every entry's numbers
at its main-path shape) and last {"ok": true, "device": {...}} ("partial"
where --phases ran a subset); --iters N sets the timed runs per median.

Without a CUDA device, or without the repository beside it, it fails
before printing any result.  Needs no network.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# the cases (tests/torch_cases.py); ew_limbs for tools/rns_decompose_scale.py
from torch_cases import (BOOT15_K5, CASES, LOGQ, MODES, N14, NTT4_PATH,  # noqa: E402,F401
                         NTT16, bootstrap_cases, crt_chain_ring, elementwise_cases,
                         elementwise_edge_cases, ew_compare, ew_limbs, kernel_ring,
                         ntt4_compare, ntt4_edge_cases, ntt4_input, ntt4_max_sums,
                         ring16_cases)

KERNELS = {
    "ntt": {"source": "gpqhe_tpu_torch/csrc/ntt.cu", "word": 64,
            "replaces": "gpqhe_tpu/ops/ntt_pallas.py:303"},
    "ntt32": {"source": "gpqhe_tpu_torch/csrc/ntt32.cu", "word": 32,
              "replaces": "gpqhe_tpu/ops/ntt_pallas32.py:183"},
}
# the u64 kernel again, reported at the shapes of the bootstrap's ring
# (logn=15/logq=881; the shapes come from the context, see bootstrap_cases)
KERNELS["ntt15"] = dict(KERNELS["ntt"], lib="ntt")
# both kernels again on the per-shard plans of the mesh programs (local
# length n/S, tables of one coefficient shard, the ring's n^-1)
KERNELS["nttmesh"] = dict(KERNELS["ntt"], lib="ntt")
KERNELS["ntt32mesh"] = dict(KERNELS["ntt32"], lib="ntt32")
KERNELS["ntt15mesh"] = dict(KERNELS["ntt"], lib="ntt")
# the u64 kernel at the logn=16 ring of gpubench's ckks-n16-q1751 (58 levels: the
# product's basis 60 primes, the key switch's 90), the passes at (8, 8)
KERNELS["ntt16"] = dict(KERNELS["ntt"], lib="ntt")
# the u32 kernel on tests/test_crt_mode.py's logp=9 chain (10-11-bit primes, n=2^4)
KERNELS["ntt32p9"] = dict(KERNELS["ntt32"], lib="ntt32")
ITERS = 10      # timed runs per median
CALLS = 40      # launches between one pair of events in a device-time run
SLEEP_CYCLES = 10_000_000          # the sleep such a run starts behind: ~5 ms
MAX_SLEEP_CYCLES = 1_000_000_000   # ~0.5 s: past this the host is not ahead

# Peaks of one H100 SXM for the bound: 3.35 TB/s of HBM3 (NVIDIA's data
# sheet).  Integer rate: the data sheet's 67 TFLOP/s of fp32 is 128 lanes
# per SM issuing one 2-flop FMA per clock; the Hopper white paper gives an
# SM 64 int32 lanes, so the card issues 67e12 / 2 / 2 = 16.75e12 integer
# multiply-add instructions (IMAD) per second.
PEAK_BYTES_S = 3.35e12
PEAK_IMAD_S = 16.75e12
# 32-bit multiply instructions per butterfly (adds and compares not counted,
# so the operation bound is a floor): the u64 Shoup product is one 64x64
# high product (4 IMAD of 32x32->64) and two 64-bit low products (3 each);
# the u32 one is one high and two low 32-bit products.
IMAD_PER_MUL = {64: 10, 32: 3}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median milliseconds of fn() over iters runs, timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms_runs(fn, rounds: int, calls: int = CALLS) -> list:
    """Device milliseconds per call of fn() without the host's share: each
    of `rounds` readings is `calls` calls between one pair of events,
    enqueued while the device sits in a sleep kernel, so that every launch
    is waiting in the stream before the first one starts.  That is checked:
    a reading counts only if the sleep had not ended when the last call was
    enqueued (the event behind the sleep not yet reached); else the sleep is
    doubled and the round repeated.  fn sees the same tensors every time:
    its inputs are L2-warm."""
    import torch
    fn()
    torch.cuda.synchronize()
    out, sleep = [], SLEEP_CYCLES
    while len(out) < rounds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        a.record()
        for _ in range(calls):
            fn()
        host_ahead = not a.query()
        b.record()
        b.synchronize()
        if host_ahead:
            out.append(a.elapsed_time(b) / calls)
        elif sleep > MAX_SLEEP_CYCLES:
            raise RuntimeError(f"the host cannot enqueue {calls} calls inside a sleep of "
                               f"{sleep} cycles: no device time without the host's share")
        else:
            sleep *= 2
    return out


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn(): the wrapper's checks, allocation
    and enqueue, over un-synchronised calls on an idle device."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def pass_breakdown(fn, calls: int = 20) -> dict:
    """Microseconds per call of each device kernel of fn(), by name, from
    torch.profiler over `calls` back-to-back calls: how a transform's time
    splits over its passes, and whether they overlap (their sum against the
    time per launch).  Raises if the profiler shows no NTT kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):        # a capture now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SLEEP_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "ntt" in e.name:
                key = short_kernel_name(e.name)
                out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / calls
        if out:
            return out
    raise RuntimeError("the profiler saw no NTT pass kernel in four captures: no time per pass")


def ntt_bound(word: int, mode: str, shape) -> dict:
    """The least time the card could take for one NTT call of this shape:
    the larger of bytes over the memory rate (every 64-bit residue read once
    and written once, the twiddle and companion rows of the dim primes once)
    and multiply instructions over the integer rate."""
    n, dim = shape[-1], shape[-2]
    nslab = 1
    for s in shape[:-1]:
        nslab *= s
    nbytes = 2 * nslab * n * 8 + 2 * dim * n * (word // 8)
    muls = nslab * (n // 2) * (n.bit_length() - 1)        # one per butterfly
    if mode != "fwd":
        muls += nslab * n                                  # the final scaling
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = muls * IMAD_PER_MUL[word] / PEAK_IMAD_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def phase_build():
    from gpqhe_tpu_torch.ops import (cuda_build, limbs_cuda, modmath_cuda, ntt4_cuda, ntt_cuda,
                                     ntt_cuda32, rns_cuda)
    mods = (ntt_cuda, ntt_cuda32, modmath_cuda, rns_cuda, limbs_cuda, ntt4_cuda)
    t0 = time.time()
    cuda_build.build([m.SOURCE for m in mods])          # one nvcc each, all together
    for m in mods:
        m.load_library()
    secs = time.time() - t0
    ptxas = {os.path.basename(src): ptxas_summary(log)
             for src, log in cuda_build.BUILD_LOGS.items()}
    rows = row_kernel_resources(rns_cuda, limbs_cuda, modmath_cuda, ntt4_cuda)
    sass = {os.path.basename(m.SOURCE): sass_multiplies(cuda_build.library_path(m.SOURCE))
            for m in mods}
    emit({"phase": "build", "seconds": secs, "gpu": gpu_line(), "ptxas": ptxas,
          "row_kernels": rows, "sass_multiplies": sass})
    local = {k: v for k, v in rows.items() if v.get("STACK", 1) or v.get("LOCAL", 1)}
    if local:
        raise AssertionError(f"kernels with a stack frame or local memory: {local}")
    mma = sass["ntt4.cu"] and {k: v["tensor_core"] for k, v in sass["ntt4.cu"].items()}
    if mma is not None and (len(mma) != ROW_KERNELS["ntt4.cu"] or not all(mma.values())):
        raise AssertionError(f"K8 instantiations without tensor-core products in SASS: {mma}")
    mma = sass["rns.cu"] and {k: v["tensor_core"] for k, v in sass["rns.cu"].items()
                              if "_kernel_mma" in k}
    if mma is not None and (len(mma) != RNS_MMA or not all(mma.values())):
        raise AssertionError(f"digit-product or tensor-core decompose instantiations without "
                             f"tensor-core products in SASS: {mma}")


# instantiations of the gated kernels by source: K7's eight chains on rows of
# one chunk and of more, its word kernel by word and by pair for mask_bits
# and select, and the fill by word and by pair; the lift (on int64 digit
# sums) at 1, 2, 4, 5 and 6 chunks, decompose's IMAD kernel, and the digit
# product and decompose's tensor-core kernel by the bytes of a residue or constant
# (8, 4: RNS_MMA, each with IMMA in its SASS); K5's elementwise kernel by op,
# the cross terms, the key products and the sum by mode; K8's stage by byte
# planes (2, 4, 8) and transpose
RNS_MMA = 4
ROW_KERNELS = {"limbs.cu": 22, "rns.cu": 6 + RNS_MMA, "modmath.cu": 9, "ntt4.cu": 6}


def resource_usage(library: str) -> dict:
    """cuobjdump --dump-resource-usage of a built library: per kernel its
    registers (REG), stack frame (STACK), static shared memory (SHARED) and
    local memory a thread (LOCAL: spills and arrays that did not fit in
    registers); {} without the tool."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "--dump-resource-usage", library], capture_output=True,
                         text=True, timeout=120)
    usage, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function (\S+?):?\s*$", ln) or re.search(r"Function (\S+?):\s", ln)
        if m:
            fn = m.group(1)
        if fn and "REG:" in ln:
            usage[fn] = {k: int(v)
                         for k, v in re.findall(r"\b(REG|STACK|SHARED|LOCAL):(\d+)", ln)}
    return usage


def row_kernel_resources(rns_cuda, limbs_cuda, modmath_cuda, ntt4_cuda) -> dict:
    """The resource usage (resource_usage) of every instantiation of K7 (all
    of limbs.cu's kernels), of rns.cu's (the CRT lift, decompose, the digit
    split), of K5 (all of modmath.cu's) and of K8 (all of ntt4.cu's) in the
    libraries as loaded, built in this run or earlier.  Raises unless each
    source has exactly ROW_KERNELS of them."""
    from gpqhe_tpu_torch.ops import cuda_build
    out, seen = {}, {}
    for m in (limbs_cuda, rns_cuda, modmath_cuda, ntt4_cuda):
        src = os.path.basename(m.SOURCE)
        for fn, v in resource_usage(cuda_build.library_path(m.SOURCE)).items():
            if src != "rns.cu" or "rns_" in fn:
                out[fn] = v
                seen[src] = seen.get(src, 0) + 1
    if seen != ROW_KERNELS:
        raise AssertionError(f"cuobjdump reported row kernels {seen}, expected {ROW_KERNELS}: "
                             f"{sorted(out)}")
    return out


def short_kernel_name(name: str) -> str:
    """A pass instantiation by pass, log2 size and direction, mangled or not
    (ntt_col_pass<7, false> -> "col L7 fwd"); any other kernel by its name."""
    import re
    t = (re.search(r"ntt_(col|row)_passILi(\d+)ELb([01])E", name)
         or re.search(r"ntt_(col|row)_pass<(\d+), *(true|false|[01])>", name))
    if t:
        return f"{t.group(1)} L{t.group(2)} {'inv' if t.group(3) in ('1', 'true') else 'fwd'}"
    return name


def ptxas_summary(log: str) -> dict:
    """nvcc -Xptxas -v per kernel: registers, spill and stack bytes, static
    shared memory."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = short_kernel_name(m.group(1))
            out[name] = {}
        elif name and "bytes stack frame" in ln:
            v = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[name].update(stack=v[0], spill_stores=v[1], spill_loads=v[2])
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def sass_multiplies(library: str):
    """Static count of integer multiply instructions (IMAD*, IMUL*) per
    kernel in the built library, and of its tensor-core products
    ("tensor_core": IMMA or HGMMA), from cuobjdump -sass; None without the
    tool.  It covers a kernel's whole body (both butterflies, the final
    scaling and the index arithmetic), so it bounds IMAD_PER_MUL from
    above."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                         timeout=120)
    if out.returncode != 0:
        return None
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            fn = short_kernel_name(ln.split("Function :")[1].strip())
            counts[fn] = {"IMAD": 0, "IMAD.WIDE": 0, "IMAD.HI": 0, "IMAD.MOV": 0, "other_mul": 0,
                          "tensor_core": 0}
        elif fn and (" IMMA" in ln or " HGMMA" in ln):
            counts[fn]["tensor_core"] += 1
        elif fn and (" IMAD" in ln or " IMUL" in ln or " UIMAD" in ln):
            op = ln.split("*/")[1].split()[0] if "*/" in ln else ""
            if op.startswith("@"):
                op = ln.split("*/")[1].split()[1]
            key = ("IMAD.MOV" if op.startswith("IMAD.MOV") else
                   "IMAD.WIDE" if op.startswith("IMAD.WIDE") else
                   "IMAD.HI" if op.startswith("IMAD.HI") else
                   "IMAD" if op.startswith("IMAD") else "other_mul")
            counts[fn][key] += 1
    return counts


def compare_kernel(kernel: str, mode: str, shape, iters: int, rng,
                   breakdown: bool = False) -> dict:
    """One kernel entry at a ring's own plan of shape[-2] primes against the
    plain twin (compare_plan)."""
    n, dim = shape[-1], shape[-2]
    ring = kernel_ring(KERNELS[kernel].get("lib", kernel), n.bit_length() - 1, dim)
    return compare_plan(kernel, ring.ntt_mod, ring.ntt_plan(dim), mode, shape, iters, rng,
                        breakdown=breakdown)


def compare_plan(kernel: str, ntt_mod, plan, mode: str, shape, iters: int, rng,
                 breakdown: bool = False, timed: bool = True,
                 tag: str = "kernels", **note) -> dict:
    """One kernel entry on one plan against the plain twin on random
    residues on the card: torch.equal, then (with timed) the device time per
    launch in two turns, the wrapper's host time and the twin's median.
    Raises if the two differ."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.ops import ntt_cuda
    from gpqhe_tpu_torch.ops.modmath import torch_to_u64

    ps = torch_to_u64(plan.ba.ps)
    host = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64)
            % ps[:, None]).astype(np.int64)
    a = torch.from_numpy(host).to(plan.ba.ps.device)
    scaled = mode == "inv_scaled"
    if mode == "fwd":
        def kern():
            return ntt_mod.ntt(a, plan)

        def plain():
            return ntt_cuda.plain_ntt(a, plan)
    else:
        def kern():
            return ntt_mod.intt(a, plan, scaled=scaled)

        def plain():
            return ntt_cuda.plain_intt(a, plan, scaled)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    err = int((got - want).abs().max().item())
    out = {"phase": tag, "kernel": kernel, "entry": mode, "shape": list(shape), **note,
           "equal": equal, "max_abs_err": err}
    if timed:
        runs = [device_ms_runs(kern, iters) for _ in range(2)]
        out.update({"ms": median(runs[0] + runs[1]), "turn_ms": [median(r) for r in runs],
                    "host_us": host_us(kern),
                    "plain_ms": cuda_ms(plain, max(3, iters // 4)),
                    **ntt_bound(KERNELS[kernel]["word"], mode, shape)})
    if breakdown:
        out["pass_us"] = pass_breakdown(kern)
    emit(out)
    if not equal:
        raise AssertionError(f"CUDA {kernel} {mode} {shape} differs from its twin")
    return out


def phase_kernels(iters: int, cases: dict = CASES, tag: str = "kernels") -> dict:
    """Every kernel entry against its twin at the given cases; returns, per
    entry name, the numbers of its main-path shape."""
    import numpy as np
    rng = np.random.default_rng(2024)
    result = {}
    for kernel, cases in cases.items():
        for mode, shape in cases:
            name = f"{kernel}_{mode}"
            main = name not in result          # the first case is the main shape
            r = compare_kernel(kernel, mode, shape, iters if main else max(3, iters // 4), rng,
                               breakdown=main)
            if main:
                result[name] = {k: r[k] for k in ("max_abs_err", "ms", "host_us",
                                                  "plain_ms", "bound_ms", "bound_by")}
                result[name]["shape"] = list(shape)
            result[name]["max_abs_err"] = max(result[name]["max_abs_err"], r["max_abs_err"])
    emit({"phase": tag, "summary": "device ms per launch at the main-path shapes",
          "ms": {k: v["ms"] for k, v in result.items()},
          "bound_share": {k: v["bound_ms"] / v["ms"] for k, v in result.items()}})
    return result


def phase_kernels15(iters: int) -> dict:
    """The u64 kernel at the shapes the bootstrap's engine launches
    (logn=15/logq=881/slots=4/Delta=2^30, read from an engine on the card:
    bootstrap_cases), on `kernels15` lines."""
    import torch
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.scheme.engine import CKKS
    eng = CKKS(HeContext(logn=15, q=1 << LOGQ[15], slots=4, Delta=1 << 30),
               device=torch.device("cuda"))
    return phase_kernels(iters, bootstrap_cases(eng), tag="kernels15")


def phase_logp9(iters: int) -> dict:
    """The u32 kernel on tests/test_crt_mode.py's logp=9 chain (six primes of
    10-11 bits at n=2^4) against its twin at [3, 16], each mode timed."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.ops import ntt_cuda32
    ring = crt_chain_ring(torch.device("cuda"))
    if ring.ntt_mod is not ntt_cuda32:
        raise AssertionError("the logp=9 chain does not select the u32 kernel")
    rng = np.random.default_rng(9)
    out = {}
    for mode in MODES:
        r = compare_plan("ntt32p9", ring.ntt_mod, ring.ntt_plan(3), mode, (3, ring.pctx.n),
                         iters, rng)
        out[f"ntt32p9_{mode}"] = {k: r[k] for k in ("max_abs_err", "ms", "host_us", "plain_ms",
                                                    "bound_ms", "bound_by", "shape")}
    return out


# ---------------------------------------------------------------------------
# the elementwise kernels (K4-K7): the GPU counterparts of XLA's fusion of the
# JAX package's jnp chains, not of Pallas kernels
# ---------------------------------------------------------------------------

EW_KERNELS = {
    "decompose": {"source": "gpqhe_tpu_torch/csrc/rns.cu", "replaces": "gpqhe_tpu/ops/rns.py:110"},
    "modmath": {"source": "gpqhe_tpu_torch/csrc/modmath.cu",
                "replaces": "gpqhe_tpu/ops/modmath.py:58"},
    "crt": {"source": "gpqhe_tpu_torch/csrc/rns.cu", "replaces": "gpqhe_tpu/ops/rns.py:200"},
    "limbs": {"source": "gpqhe_tpu_torch/csrc/limbs.cu", "replaces": "gpqhe_tpu/ops/limbs.py:44"},
}
# the JAX function each entry stands in for, where it is not its kernel's
EW_REPLACES = {
    "modmath_mont_mul": "gpqhe_tpu/ops/modmath.py:52", "modmath_to_mont": "gpqhe_tpu/ops/modmath.py:67",
    "modmath_addmod": "gpqhe_tpu/ops/modmath.py:98", "modmath_submod": "gpqhe_tpu/ops/modmath.py:104",
    "modmath_summod": "gpqhe_tpu/scheme/engine.py:938",
    "modmath_cross_terms": "gpqhe_tpu/scheme/engine.py:535",
    "modmath_key_products": "gpqhe_tpu/scheme/engine.py:554",
    "modmath_mulmod_sum": "gpqhe_tpu/scheme/engine.py:929",
    "limbs_add_scalar_bit": "gpqhe_tpu/ops/limbs.py:55", "limbs_sub": "gpqhe_tpu/ops/limbs.py:68",
    "limbs_neg": "gpqhe_tpu/ops/limbs.py:77", "limbs_select": "gpqhe_tpu/ops/limbs.py:82",
    "limbs_geq_const": "gpqhe_tpu/ops/limbs.py:87", "limbs_mask_bits": "gpqhe_tpu/ops/limbs.py:111",
    "limbs_rshift_round": "gpqhe_tpu/ops/limbs.py:144",
    "limbs_rshift_round_mask": "gpqhe_tpu/scheme/engine.py:757",
    "limbs_from_digits16": "gpqhe_tpu/ops/limbs.py:210",
    "limbs_fill_rows": "gpqhe_tpu/scheme/engine.py:164 (const_pt's and ecd's host build and copy)",
}

def ew_bound(case, route: str | None = None) -> dict:
    """The least time of a case: its bytes over the memory rate, its 32-bit
    multiplies over the integer rate, or (int8_ops) its u8 tensor-core
    operations over the int8 rate, whichever is largest.  A decompose case
    counts the operations of `route` (default: the route its K takes)."""
    if "route_ops" in case:
        from gpqhe_tpu_torch.ops import rns_cuda
        route = route or ("mma" if rns_cuda.takes_mma(case["k"]) else "imad")
        case = {**case, **case["route_ops"][route], "route": route}
    t_bytes = case["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = max(case["imad"] / PEAK_IMAD_S, case.get("int8_ops", 0) / PEAK_INT8_S) * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_ms": t_bytes, "operations_ms": t_ops}
    if "imad_mont" in case and case.get("route", "imad") == "imad":
        out["mont_operations_ms"] = case["imad_mont"] / PEAK_IMAD_S * 1e3
    if "route" in case:
        out["route"] = case["route"]
    return out


def decompose_route_rows(case, iters: int, phase: str, ring) -> dict:
    """Both routes of decompose at a case's shape (torch_cases'
    decompose_routes: the IMAD kernel and the tensor cores, whichever the
    dispatcher would take at its K), each torch.equal to the plain version
    and timed as the entries are, with its own bound; one line a route.
    K* (rns_cuda.MMA_MIN_LIMBS) comes from these rows."""
    import torch
    want = case["plain"]()
    out = {}
    for route, fn in case["routes"].items():
        got = fn()
        torch.cuda.synchronize()
        eq = torch.equal(got, want)
        row = {"phase": phase, "ring": ring, "kernel": "decompose", "route": route,
               "shape": case["shape"], "equal": eq}
        if eq:
            runs = [device_ms_runs(fn, iters) for _ in range(2)]
            row.update({"ms": median(runs[0] + runs[1]), "turn_ms": [median(r) for r in runs],
                        "host_us": host_us(fn), **ew_bound(case, route)})
            out[route] = row
        emit(row)
        if not eq:
            raise AssertionError(f"decompose's {route} route at {case['shape']} differs from "
                                 f"its plain version")
    return out


def retimed15(entry: str) -> tuple:
    """The cases (indices into elementwise_cases' list of the entry) timed
    at logn=15 too (`kernels15` lines): K7 and the lift, whose rows are 28
    limbs wide there, at their main shape; decompose into the product's
    and the key switch's bases ([2^15, 28] -> 31 and 47 primes); the digit
    product of the product's three polys and of the key switch's exact
    reconstruct ([3, 31, 2^15], scaled [47, 2^15]); every K5 entry at its
    main shape, but those the bootstrap launches, which are timed at its
    shape classes instead (BOOT15_K5)."""
    if entry == "decompose":
        return (0, 1)
    if entry == "crt_digit_split":
        return (1, 2)
    if entry in {e for e, *_ in BOOT15_K5}:
        return ()          # timed at the bootstrap's shape classes (the boot15 cases)
    return (0,) if entry.startswith(("limbs_", "modmath_")) or entry == "crt_lift" else ()


def phase_kernels16(iters: int) -> dict:
    """The logn=16 ring of gpubench's ckks-n16-q1751 on the card: the NTT at
    NTT16 against its twin (lines of kernel `ntt16`), then every
    ring16_cases entry against its plain version on `kernels16` lines, each
    timed (device ms in two turns, host µs, the plain version's ms) with
    its bound.  Raises on any difference."""
    import torch
    result = phase_kernels(iters, {"ntt16": NTT16}, tag="kernels16")
    for entry, cases in ring16_cases(torch.device("cuda")).items():
        for case in cases:
            got, want = case["kern"](), case["plain"]()
            torch.cuda.synchronize()
            eq, err, extra = ew_compare(got, want)
            out = {"phase": "kernels16", "kernel": entry, "shape": case["shape"], "equal": eq,
                   "max_abs_err": err, **extra}
            if eq:
                runs = [device_ms_runs(case["kern"], iters) for _ in range(2)]
                out.update({"ms": median(runs[0] + runs[1]), "turn_ms": [median(r) for r in runs],
                            "host_us": host_us(case["kern"]),
                            "plain_ms": cuda_ms(case["plain"], max(3, iters // 4)),
                            **ew_bound(case)})
                result[f"{entry} {case['shape']}"] = {k: out[k] for k in (
                    "max_abs_err", "ms", "host_us", "plain_ms", "bound_ms", "bound_by")}
            emit(out)
            if not eq:
                raise AssertionError(f"CUDA {entry} {case['shape']} at logn=16 differs from "
                                     f"its plain version")
            if entry == "decompose":
                decompose_route_rows(case, iters, "kernels16", [16, 59])
    emit({"phase": "kernels16", "summary": "device ms per launch at the logn=16 shapes",
          "ms": {k: v["ms"] for k, v in result.items()},
          "bound_share": {k: v["bound_ms"] / v["ms"] for k, v in result.items()}})
    return result


def phase_elementwise(iters: int, rings=((14, 59), (14, 29), (15, 59)), tag: str = "kernels",
                      timed_ring=(14, 59), ring15=(15, 59)) -> dict:
    """Every entry of K4-K7 against its plain version on the card at the
    shapes of the given rings, then K7 and the lift at the edges of their
    designs (elementwise_edge_cases); at timed_ring the first case of each
    entry is timed (device ms in two turns, host µs, the plain version's ms,
    the library call's where there is one, and their ratio) and returned
    with its bound; at ring15 the same for K7 and the lift, on `kernels15`
    lines; at both, the cases marked `wide` too (rows of more than 32 limbs:
    the exact lift, geq_const at 62 and 125 limbs), summed up on a `wide`
    line of each phase.  Raises on any difference."""
    import torch
    result, at15, wide = {}, {}, {tag: {}, "kernels15": {}}
    dev = torch.device("cuda")

    def check(entry, case, out):
        got, want = case["kern"](), case["plain"]()
        torch.cuda.synchronize()
        eq, err, extra = ew_compare(got, want)
        out.update({"kernel": entry, "shape": case["shape"], "equal": eq, "max_abs_err": err,
                    **extra})
        return eq, err

    for logn, logp in rings:
        for entry, cases in elementwise_cases(logn, logp, dev).items():
            for i, case in enumerate(cases):
                main = (logn, logp) == timed_ring and i == 0
                main15 = (logn, logp) == ring15 and (i in retimed15(entry)
                                                    or case.get("boot15", False))
                at_wide = case.get("wide") and (logn, logp) in (timed_ring, ring15)
                phase = "kernels15" if main15 or (at_wide and (logn, logp) == ring15) else tag
                out = {"phase": phase, "ring": [logn, logp]}
                eq, err = check(entry, case, out)
                if (main or main15 or at_wide) and case.get("timed", True):
                    runs = [device_ms_runs(case["kern"], iters) for _ in range(2)]
                    lib = case.get("library")
                    out.update({"ms": median(runs[0] + runs[1]),
                                "turn_ms": [median(r) for r in runs],
                                "host_us": host_us(case["kern"]),
                                "plain_ms": cuda_ms(case["plain"], max(3, iters // 4)),
                                # the library call timed as the kernel is
                                # (device time, without the host's share)
                                "library_ms": (median(device_ms_runs(lib, max(3, iters // 4)))
                                               if lib else None),
                                **ew_bound(case)})
                    if lib:
                        out["ms_over_library"] = out["ms"] / out["library_ms"]
                    if at_wide:
                        out["wide"] = True
                    keep = {k: out[k] for k in ("max_abs_err", "ms", "host_us", "plain_ms",
                                                "library_ms", "bound_ms", "bound_by")}
                    keep["shape"] = case["shape"]
                    if at_wide:
                        wide[phase][f"{entry} {case['shape']}"] = keep
                    elif main:
                        result[entry] = keep
                    else:
                        at15[entry if entry not in at15 else f"{entry} {case['shape']}"] = keep
                emit(out)
                if not eq:
                    raise AssertionError(f"CUDA {entry} {case['shape']} at logn={logn} "
                                         f"logp={logp} differs from its plain version")
                if entry == "decompose" and ((logn, logp) == timed_ring and i < 2 or main15):
                    decompose_route_rows(case, iters, phase, [logn, logp])
                if entry in result:
                    result[entry]["max_abs_err"] = max(result[entry]["max_abs_err"], err)
    for case in elementwise_edge_cases(dev):
        out = {"phase": tag, "ring": "edge"}
        eq, err = check(case["entry"], case, out)
        emit(out)
        if not eq:
            raise AssertionError(f"CUDA {case['entry']} {case['shape']} at an edge of its "
                                 f"design differs from its plain version")
        if case["entry"] in result:
            result[case["entry"]]["max_abs_err"] = max(result[case["entry"]]["max_abs_err"], err)
    for name, res in ((tag, result), ("kernels15", at15)):
        emit({"phase": name, "summary": "elementwise kernels, device ms per launch at the "
                                        "main-path shapes",
              "ms": {k: v["ms"] for k, v in res.items()},
              "bound_share": {k: v["bound_ms"] / v["ms"] for k, v in res.items()},
              "over_library": {k: v["ms"] / v["library_ms"] for k, v in res.items()
                               if v["library_ms"]}})
        emit({"phase": name, "summary": "wide rows, device ms per launch",
              "ms": {k: v["ms"] for k, v in wide[name].items()},
              "bound_ms": {k: v["bound_ms"] for k, v in wide[name].items()},
              "host_us": {k: v["host_us"] for k, v in wide[name].items()}})
    return result


def mesh_devices(n: int):
    """(devices for an n-position mesh, what they are): distinct GPUs where
    the machine has n, else the first card n times (a virtual mesh)."""
    import torch
    have = torch.cuda.device_count()
    if have >= n:
        return None, f"{n} distinct GPUs"
    return [torch.device("cuda", 0)] * n, f"virtual: cuda:0 x {n} ({have} GPU visible)"


def mesh_kernel_entry(kernel: str, pctx, mesh, dim: int, klv: int, cases, iters: int,
                      rng, report: bool = True, breakdown: bool = True) -> dict:
    """The NTT kernel on the per-shard plans of a mesh over a basis of dim
    primes: every coefficient shard of the last limb shard (the last
    dim/limb rows of the basis, tables of that coefficient shard, the ring's
    n^-1) against the twin on the same local tables.  cases: (mode, leading
    shape) pairs; the last shard's first case of each mode is also timed
    and, with report, returned (with breakdown: split by pass)."""
    from gpqhe_tpu_torch.parallel import mesh as pm
    limb, coeff = mesh.shape["limb"], mesh.shape["coeff"]
    shape3 = (limb, coeff, mesh.shape["batch"])
    splan, C = pm._basis_consts(mesh, pctx, dim, klv, "a")
    result = {}
    for s in range(coeff):
        plan = C[limb - 1, s, 0]["a_ntt"]
        if (plan.n, plan.dim) != (pctx.n // coeff, dim // limb) or plan.scale_phat is not None:
            raise AssertionError(f"shard plan is [{plan.dim}, {plan.n}], not the local shape")
        for mode, lead in cases:
            main = s == coeff - 1 and mode not in result
            r = compare_plan(kernel, splan["ntt"], plan, mode, tuple(lead) + (plan.dim, plan.n),
                             iters, rng, timed=main,
                             breakdown=main and report and breakdown,
                             tag="mesh_kernels", mesh=list(shape3), coeff_shard=s)
            if main:
                result[mode] = {k: r[k] for k in ("max_abs_err", "ms", "host_us",
                                                  "plain_ms", "bound_ms", "bound_by", "shape")}
            if mode in result:
                result[mode]["max_abs_err"] = max(result[mode]["max_abs_err"], r["max_abs_err"])
    return result if report else {}


def phase_mesh(iters: int) -> dict:
    """The NTT kernels on the mesh programs' per-shard plans: both word sizes
    at logn=14/logq=438 on (2,2,2) (n/S = 2^13: mul_rs's shapes; the key
    switch's basis too) and on (2,4,2) (n/S = 2^12), the u64 kernel at
    logn=15/logq=881 on (2,4,1) (coeff2slot's key switch at the top level).
    Returns the kernel rows of the timed shard."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.parallel.mesh import make_he_mesh3
    from gpqhe_tpu_torch.scheme.engine import CKKS
    devices, what = mesh_devices(8)
    emit({"phase": "mesh", "devices": what})
    rng = np.random.default_rng(5)
    kernels = {}
    for kernel, logp in (("nttmesh", 59), ("ntt32mesh", 29)):
        meshes = {S: make_he_mesh3(2 * S, limb=2, coeff=S,
                                   devices=None if devices is None else devices[:2 * S])
                  for S in (2, 4)}
        ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50, logp=logp)
        pctx = kernel_ring(KERNELS[kernel]["lib"], 14, 16).pctx
        dim_m = ctx.dim_mul(ctx.L) + ctx.dim_mul(ctx.L) % 2      # padded to the limb axis
        dim_s = ctx.dim_swk(ctx.L) + ctx.dim_swk(ctx.L) % 2
        r = mesh_kernel_entry(kernel, pctx, meshes[2], dim_m, 14,
                              [("fwd", (4, 1)), ("inv", (3, 1))], iters, rng)
        mesh_kernel_entry(kernel, pctx, meshes[2], dim_s, 14,
                          [("fwd", (1,)), ("inv", (2, 1))], iters, rng, report=False)
        mesh_kernel_entry(kernel, pctx, meshes[4], dim_m, 14,
                          [("fwd", (4, 1)), ("inv", (3, 1))], iters, rng, report=False)
        kernels.update({f"{kernel}_{mode}": v for mode, v in r.items()})
    ctx = HeContext(logn=15, q=1 << LOGQ[15], slots=4, Delta=1 << 30)
    klv = CKKS(ctx, device=torch.device("cuda")).kl(ctx.L)
    dim_s = ctx.dim_swk(ctx.L) + ctx.dim_swk(ctx.L) % 2
    mesh = make_he_mesh3(8, limb=2, coeff=4, devices=devices)      # batch=1: one ciphertext
    r = mesh_kernel_entry("ntt15mesh", ctx.poly, mesh, dim_s, klv,
                          [("fwd", (1,)), ("inv", (2, 1))], iters, np.random.default_rng(15))
    kernels.update({f"ntt15mesh_{mode}": v for mode, v in r.items()})
    return kernels


# ---------------------------------------------------------------------------
# K8 (csrc/ntt4.cu): the four-step ("matmul") NTT's stage, one launch of a
# u8 tensor-core product a stage
# ---------------------------------------------------------------------------

KERNELS["ntt4"] = {"source": "gpqhe_tpu_torch/csrc/ntt4.cu",
                   "replaces": "gpqhe_tpu/ops/ntt4.py:130"}
# the JAX code the entry stands in for: _moddot (digit planes, sums,
# carries, reduction) with the multiplies around it (pre-twist 182, twiddle
# 187 / 206, transpose 189 / 205, untwist 209, phat^-1 ring/poly.py:199)
NTT4_REPLACES = {"ntt4_stage": "gpqhe_tpu/ops/ntt4.py:130"}
PEAK_INT8_S = 1979e12      # int8 on the tensor cores, dense (NVIDIA's data sheet), ops a second


def ntt4_bound(args) -> dict:
    """The least time of one stage launch: the larger of its bytes (every
    word read once and written once, its tables and W's byte planes once)
    over the memory rate and its u8 tensor-core operations (2 M K J P8^2 a
    slab) over the int8 rate."""
    import math
    x, plan, w, rows, cols, transpose, pre, post, scale = args
    K, J = (cols, rows) if transpose else (rows, cols)
    slabs = math.prod(x.shape[:-1])
    nbytes = (16 * x.numel() + plan.w(w, "u8").numel()
              + sum(8 * t.numel() for t in (pre, post, scale) if t is not None))
    ops = 2 * K * K * J * plan.planes8 ** 2 * slabs
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_INT8_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes_ms": t_bytes, "int8_ms": t_ops, "int8_ops": ops, "bytes": nbytes}


def ntt4_time(x, plan, mode: str, steps, bring, iters: int) -> dict:
    """The transform's launches timed on the card as the NTT's are (device ms
    in two turns, host µs, the plain version's ms, the bound and the shares
    of its int8-operation and byte bounds), beside each the f64 torch.bmm of
    the plain version's digit planes alone (library_ms: what the GEMM cost
    before the fused kernel), and the whole transform beside the butterfly
    kernel's at the same shape (bring: the butterfly ring on the same
    primes)."""
    import torch
    from gpqhe_tpu_torch.ops import ntt4, ntt4_cuda
    few = max(3, iters // 4)
    out = {"steps": []}
    for _, args, _ in steps:
        x_, plan_, w, rows, cols, transpose, pre = args[:7]
        runs = [device_ms_runs(lambda a=args: ntt4_cuda.stage(*a), iters) for _ in range(2)]
        ms = median(runs[0] + runs[1])
        dig = plan_.w(w, "dig")
        xd = ntt4.plain_ntt4_split(x_, plan_, rows, cols, transpose, pre)
        b = ntt4_bound(args)
        out["steps"].append({
            "entry": "ntt4_stage", "ms": ms, "turn_ms": [median(r) for r in runs],
            "host_us": host_us(lambda a=args: ntt4_cuda.stage(*a)),
            "plain_ms": cuda_ms(lambda a=args: ntt4.plain_ntt4_stage(*a), few),
            "library_ms": median(device_ms_runs(lambda: torch.bmm(dig, xd), iters)),
            "transpose": transpose, "pre": pre is not None, "post": args[7] is not None,
            "scale": args[8] is not None, **b,
            "share_of_int8": b["int8_ms"] / ms, "share_of_bytes": b["bytes_ms"] / ms})
    scaled = mode == "inv_scaled"
    if mode == "fwd":
        def whole():
            return ntt4.kernel_ntt4(x, plan)

        def butterfly():
            return bring.ntt_mod.ntt(x, bring.ntt_plan(plan.dim))
    else:
        def whole():
            return ntt4.kernel_intt4(x, plan, scaled)

        def butterfly():
            return bring.ntt_mod.intt(x, bring.ntt_plan(plan.dim), scaled=scaled)
    out["transform_ms"] = median(device_ms_runs(whole, iters))
    out["transform_host_us"] = host_us(whole)
    out["butterfly_ms"] = median(device_ms_runs(butterfly, iters))
    # the transform's bound: its words in and out once, each stage's tables
    # and W's planes once (the intermediate between the stages is the
    # design's, not the work), against both stages' operations
    nbytes = 16 * x.numel() + sum(st["bytes"] - 16 * x.numel() for st in out["steps"])
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = sum(st["int8_ms"] for st in out["steps"])
    out.update({"transform_bound_ms": max(t_bytes, t_ops),
                "transform_bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "transform_int8_ms": t_ops, "transform_bytes_ms": t_bytes,
                "transform_share_of_int8": t_ops / out["transform_ms"],
                "transform_share_of_bytes": t_bytes / out["transform_ms"]})
    return out


def phase_ntt4(iters: int) -> dict:
    """K8 against its plain version at the path's shapes on both chains (each
    stage and the whole transform torch.equal, the round trip), each shape
    timed (ntt4_time); then at its edges (ntt4_edge_cases, every logn 4-16)
    and at a stage's largest digit sums for P8 = 2, 4, 8 (ntt4_max_sums).
    Returns K8's kernel-line entry (the 59-bit chain's forward [4, 16,
    2^14]: its first stage)."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ops import ntt4, ntt4_cuda
    from gpqhe_tpu_torch.ring.poly import RingEngine

    dev = torch.device("cuda")
    result = {}
    for logp in (59, 29):
        ring = RingEngine(PolyContext(14, 1 << 438, logp=logp), device=dev, ntt_impl="matmul")
        bring = kernel_ring("ntt" if logp == 59 else "ntt32", 14, 16)
        rng = np.random.default_rng(logp + 4)
        for mode, lead_dim in NTT4_PATH[logp]:
            plan = ring.ntt4_plan(lead_dim[-1])
            ps = torch.from_numpy(np.asarray(ring.pctx.primes[:plan.dim], dtype=np.int64))
            x = (torch.from_numpy(rng.integers(0, 1 << 62, size=lead_dim + (N14,),
                                                dtype=np.int64)) % ps[:, None]).to(dev)
            equal, steps, fwd = ntt4_compare(x, plan, mode)
            back = (ntt4.kernel_intt4(fwd, plan) if mode == "fwd" else
                    ntt4.kernel_ntt4(ntt4.kernel_intt4(x, plan), plan))
            round_trip = bool(torch.equal(back, x))
            line = {"phase": "ntt4", "logp": logp, "mode": mode, "shape": list(lead_dim) + [N14],
                    "planes8": plan.planes8, "equal": equal, "round_trip": round_trip}
            line.update(ntt4_time(x, plan, mode, steps, bring, iters))
            if "ntt4_stage" not in result:          # the 59-bit chain's forward [4, 16, 2^14]
                s = line["steps"][0]
                result["ntt4_stage"] = {"max_abs_err": 0.0, "shape": line["shape"],
                                        **{k: s[k] for k in ("ms", "host_us", "plain_ms",
                                                             "library_ms", "bound_ms",
                                                             "bound_by")}}
            emit(line)
            if not (equal and round_trip):
                raise AssertionError(f"K8 {mode} {line['shape']} logp={logp}: equal={equal}, "
                                     f"round trip={round_trip}")
    plans, n_edges = {}, 0
    for case in ntt4_edge_cases():
        key = (case["logp"], case["logn"])
        if key not in plans:
            plans[key] = ntt4.make_ntt4_plan(PolyContext(case["logn"], **case["ctx"]),
                                             case["dim"], dev)
        plan = plans[key]
        x = ntt4_input(case, plan, dev)
        equal, _, fwd = ntt4_compare(x, plan, case["mode"])
        if case["mode"] == "fwd":
            equal = equal and bool(torch.equal(ntt4.kernel_intt4(fwd, plan), x))
        n_edges += 1
        if not equal:
            emit({"phase": "ntt4", "edge": case["id"], "equal": False})
            raise AssertionError(f"K8 differs from its plain version at the edge {case['id']}")
    for P8 in (2, 4, 8):
        args = ntt4_max_sums(plans[(59, 16)], P8, dev)
        if not torch.equal(ntt4_cuda.stage(*args), ntt4.plain_ntt4_stage(*args)):
            raise AssertionError(f"K8 differs at its largest digit sums, P8={P8}")
    emit({"phase": "ntt4", "summary": "edges", "cases": n_edges, "equal": True,
          "max_sums_planes8": [2, 4, 8]})
    return result


PHASES = ("build", "kernels", "kernels16", "ntt4", "mesh")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="timed runs per median (default %(default)s)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the kernel bench needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.time()

    def clock(after: str) -> None:
        emit({"phase": "clock", "after": after, "elapsed_s": round(time.time() - t_start, 1)})

    kernels = {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernels.update(phase_kernels(args.iters))
        kernels.update(phase_kernels15(args.iters))
        kernels.update(phase_logp9(args.iters))
        kernels.update(phase_elementwise(args.iters))
        clock("kernels")
    if "kernels16" in phases:
        kernels.update(phase_kernels16(args.iters))
        clock("kernels16")
    if "ntt4" in phases:
        kernels.update(phase_ntt4(args.iters))
        clock("ntt4")
    if "mesh" in phases:
        kernels.update(phase_mesh(args.iters))
        clock("mesh")

    print(gpu_line(), flush=True)
    table = {**KERNELS, **EW_KERNELS}
    replaces = {**EW_REPLACES, **NTT4_REPLACES}

    def kind(name):
        return table[name.split(" ")[0].split("_")[0]]
    emit({"kernels": [{"name": name, "route": "cuda", "source": kind(name)["source"],
                       "replaces": replaces.get(name, kind(name)["replaces"]),
                       "library_ms": None, **v}
                      for name, v in kernels.items()]})
    partial = {} if set(phases) == set(PHASES) else {"partial": phases}
    emit({"ok": True, **partial, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
