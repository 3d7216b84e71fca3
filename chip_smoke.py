#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpqhe_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and the script exits
non-zero:
  build    — compile csrc/ntt.cu and csrc/ntt32.cu with nvcc (sm_90a), one
             process each, started together, and load them; the card's name
             and power limit from nvidia-smi; per kernel instantiation
             ptxas's registers, spills, stack and shared memory; static
             multiply-instruction counts from cuobjdump.
  kernels  — each CUDA NTT (u64 words on the 59-bit chain, u32 words on the
             logp=29 chain) against the plain torch twin on the card:
             torch.equal on random residues at the paths' shapes; the
             device time per launch in two turns, each a run of many
             launches between one pair of CUDA events with the host
             enqueueing ahead of the device, inputs L2-warm; the wrapper's
             host time per call; the twin's median; the bound.
  golden   — the logn=11 replay of tests/golden/golden_logn11.json (enc,
             add, mul+rs, conj, rot1, moddown) within tests/test_golden.py's
             tolerances.
  mul_rs   — encrypt, mul_rs, decrypt at logn=14/logq=438/slots=16/Delta=2^50
             from Surf(): keypair, genrlk, ecd + enc_pk x2, mul_rs, dec, dcd;
             decode diff vs m1*m2 < 1e-5; every u64 launch counter > 0;
             keygen seconds and the mul_rs median; with it a `profile` line:
             one mul_rs under torch.profiler.
  linalg59, linalg29 — the key-switch and hoisted-gemv path at the same size
             on each chain, the engine built with no device argument:
             keypair, genrlk, genck, genrk (16 keys), enc_pk, mul_rs, rot,
             conj, mulpt, mul_rs_batch (B=8), gemv fully hoisted and BSGS
             with a restricted key bank, dec, dcd.  Gates: every decode
             within 1e-5 of the plaintext result; batch element i
             torch.equal to mul_rs of pair i; plan.fallbacks == 0; on the
             59-bit chain the gemv within 1e-9 of the reference binary's
             (tests/golden/golden_algo_linear.json); every launch counter of
             the chain's kernel > 0 and the other kernel's all 0; the two
             chains' decodes within 1e-9 of each other.  Medians, profiles
             (rot, mul_rs_batch, both gemv routes), and the kernel against
             its twin at the gemv's shapes.  After both: a `chains` line,
             mul_rs on each chain in turns (59, 29, 29, 59).
  suite    — the rest of the JAX package's test suite on the card, every gate
             raising: tests/test_crt_mode.py's logp=9 chain (six primes of
             10-11 bits at n=2^4, the u32 kernel): decompose, reconstruct
             (center=False) and the NTT round trips exact at every dim from
             dimub down to 1 (the launch counters zeroed just before and
             read just after), then the kernel against its twin at [3, 16]
             in all three modes with its times and bound;
             tests/test_kat.py's exact oracle (tests/torch_oracle.py, jax-
             free): the KAT sequence at logn=4 and the ladder sweep at logn=5
             (L=20) on both chains, every ciphertext limb-equal to the
             oracle; hoisted gemv at logn=9/logq=120 with slots=256 (full
             packing) and slots=8 (n1=4), and coeff2slot at full packing
             (logn=5/q=2^400/slots=16), both chains, decodes within 1e-5,
             plan.fallbacks == 0, U0/U1 within 1e-9 of the reference
             construction, the card's ciphertexts torch.equal to the CPU
             port's from the same stream; tests/test_full_params.py at
             logn=14/logq=438/slots=16/Delta=2^50 on the linalg59 phase's
             engine and keys (its own where that phase did not run): enc_sk,
             enc_pk, moddown, the add and mul variants, conj and rot by every
             r in 0..15, each within 1e-5.
  mesh     — the mesh engine (parallel/mesh.py, parallel/engine.py) on a
             virtual mesh that names the one card several times, or on
             distinct GPUs where torch.cuda.device_count() covers the mesh
             (the line says which).  Kernel check: the NTT kernels on
             per-shard plans (n/S = 2^13 and 2^12 of logn=14, both word
             sizes, forward and inverse) torch.equal to the twin on the same
             local tables, with device time, host time and bound; the
             coefficient-sharded NTT over S = 2, 4, 8 torch.equal to the
             single-device kernel at [16, 2^14], its inverse giving the
             input back.  Full width, logn=14/logq=438/slots=16/Delta=2^50 on
             a (2,2,2) mesh, each chain: mul_rs, rot(1), conj and the fully
             hoisted gemv on MeshCKKS torch.equal in c0 and c1 to the
             single-device CKKS on the same keys; plan.fallbacks == 0;
             decodes within 1e-5; sharded programs built; the NTT launch
             counters, zeroed before one call of each mesh op and read after,
             equal to the local transforms expected.  Medians of each mesh
             op beside the single-device op, one profiled call, the
             collectives' transfers and bytes per op, peak memory.  The copy
             path, each chain at logn=9/logq=120/slots=4/Delta=2^30: the same
             four ops on a (2,2,2) mesh whose position (l, c, b) is on the card
             when l + c is even and on the host otherwise, torch.equal to
             CKKS on the card (the first differing index where not), with
             device-copy bytes > 0 in psum, ppermute, scatter and gather and
             no view in psum or ppermute.  The CLI
             with --mesh=2x2x1:virtual ([ok]) and without :virtual (exit 2
             where the machine has fewer than 4 GPUs).  After the bootstrap
             phase, on its keys (or on keys of its own when that phase is
             not run): bootstrap.coeff2slot at logn=15/logq=881 on a (2,4,1)
             mesh torch.equal to the single-device result.
  mesh_mp  — one mesh over two processes: `python -m
             gpqhe_tpu_torch.parallel.mp_mul_rs` at logn=14/logq=438/slots=16/
             Delta=2^50, both chains in one run, 2 ranks x 4 positions on
             (2,2,2) (the limb psum crosses the ranks) and (1,4,2) (the
             coefficient swap at distance 2 does); both ranks on the one card
             over gloo (messages staged through host memory), or one card a
             rank over nccl where there are two (the lines say which and
             why).  Gates: the launcher's PASS (every rank's mul_rs, rot(1),
             conj and hoisted gemv torch.equal to the single-device engine,
             decodes within 1e-5), every rank's launches of its chain's
             kernel > 0 and of the other 0, bytes across the processes > 0 on
             each layout, staged bytes > 0 over gloo.  Per rank ms per op,
             the device busy ms of one mul_rs, bytes by kind, seconds of
             set-up and of each layout, and rank 0's one-process virtual mesh
             of the same layout (mul_rs).
  nonlinear — algo/nonlinear.py at logn=14/logq=438/slots=4/Delta=2^30 from
             Surf(), the op sequence of tests/test_golden_algo.py: m0 bit-equal
             to tests/golden/golden_algo_nonlinear.json, and he_inv(5),
             he_exp(5), he_sigmoid, he_log, he_sqrt(6) each within 1e-4 of the
             reference binary's decoded output; then the same five ops on the
             logp=29 chain against the plaintext functions at the per-op
             CLI's tolerances.  ms per op, levels consumed, NTT launches.
  cmp      — he_cmp at logn=15/logq=881/slots=4/Delta=2^30, iter=5, alpha=2:
             within 1e-4 of golden_algo_cmp.json, decision bits equal to the
             plaintext comparison.
  bootstrap — the deep-circuit main path, tests/test_bootstrap_refscale.py:
             HeContext(15, 1<<881, 4, 1<<30), keypair, rlk, ck, 16 rotation
             keys, m0 = sample_z01vec * 0.1, enc_pk, moddown to l=1,
             bootstrap(iter=None) (derives 9).  Gates: l >= 10, decode within
             1e-2 of m0, every u64 launch counter > 0 (counters zeroed just
             before the gated encrypt-bootstrap-decrypt and read just after).  Keygen seconds, the
             bootstrap median, seconds per stage, plan.fallbacks, one call
             under torch.profiler, one under op_trace, peak memory; before it
             the kernel against its twin at the shapes this ring launches.
  serialize — at the bootstrap context: save the ciphertext, rlk and the
             rotation bank, load them onto the card, torch.equal on every
             tensor, bit-equal mul_rs and rot from the loaded keys.
  cli      — `python -m gpqhe_tpu_torch mul pk` and `... exp` as
             subprocesses at their defaults on the card: exit code 0, an
             [ok] line, NTT launches > 0.
Then: the nvidia-smi line, the per-kernel JSON line (eighteen entries: the
six of the logn=14 path, the u32 kernel's three on the logp=9 chain, the u64
kernel's three at the bootstrap's logn=15 shapes, and forward and inverse on
per-shard plans for the u64 kernel, the u32 kernel and the u64 kernel on the
logn=15 mesh), and last {"ok": true, "device": {...}}.  --phases a,b,c runs a subset (the last line
then says "partial"); --iters N sets the timed runs per median.

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

N14, N16 = 1 << 14, 1 << 16
# kernel-vs-twin cases per kernel: (mode, shape); the first case of each mode
# is the shape at which the entry's time is reported (a main-path call)
CASES = {
    "ntt": [("fwd", (4, 16, N14)), ("fwd", (24, N14)), ("fwd", (8, N14)),
            ("fwd", (8, 16, N16)), ("fwd", (2, 3, 1 << 4)),
            ("inv_scaled", (3, 16, N14)), ("inv_scaled", (2, 24, N14)),
            ("inv", (8, N14)), ("inv", (8, 16, N16)), ("inv", (2, 3, 1 << 4))],
    "ntt32": [("fwd", (4, 31, N14)), ("fwd", (47, N14)), ("fwd", (16, N14)),
              ("fwd", (8, 31, N16)), ("fwd", (2, 3, 1 << 4)),
              ("inv_scaled", (3, 31, N14)), ("inv_scaled", (2, 47, N14)),
              ("inv", (16, N14)), ("inv", (8, 31, N16)), ("inv", (2, 3, 1 << 4))],
}
KERNELS = {
    "ntt": {"source": "gpqhe_tpu_torch/csrc/ntt.cu", "word": 64, "logp": 59,
            "replaces": "gpqhe_tpu/ops/ntt_pallas.py:303"},
    "ntt32": {"source": "gpqhe_tpu_torch/csrc/ntt32.cu", "word": 32, "logp": 29,
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
# the u32 kernel on tests/test_crt_mode.py's logp=9 chain (10-11-bit primes, n=2^4)
KERNELS["ntt32p9"] = dict(KERNELS["ntt32"], lib="ntt32")
LOGQ = {14: 438, 15: 881}      # the rings the paths run at, by logn
MODES = ("fwd", "inv", "inv_scaled")
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
    for attempt in range(2):        # a capture now and then comes back without device events
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
    raise RuntimeError("the profiler saw no NTT pass kernel in two captures: no time per pass")


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
    from gpqhe_tpu_torch.ops import cuda_build, ntt_cuda, ntt_cuda32
    t0 = time.time()
    cuda_build.build([ntt_cuda.SOURCE, ntt_cuda32.SOURCE])   # one nvcc each, together
    ntt_cuda.load_library()
    ntt_cuda32.load_library()
    secs = time.time() - t0
    ptxas = {os.path.basename(src): ptxas_summary(log)
             for src, log in cuda_build.BUILD_LOGS.items()}
    emit({"phase": "build", "seconds": secs, "gpu": gpu_line(), "ptxas": ptxas,
          "sass_multiplies": {os.path.basename(src): sass_multiplies(cuda_build.library_path(src))
                              for src in (ntt_cuda.SOURCE, ntt_cuda32.SOURCE)}})


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
    kernel in the built library, from cuobjdump -sass; None without the tool.
    It covers a kernel's whole body (both butterflies, the final scaling and
    the index arithmetic), so it bounds IMAD_PER_MUL from above."""
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
            counts[fn] = {"IMAD": 0, "IMAD.WIDE": 0, "IMAD.HI": 0, "IMAD.MOV": 0, "other_mul": 0}
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


_RINGS = {}


def kernel_ring(kernel: str, logn: int, dim: int):
    """A RingEngine on the card over a chain of the kernel's prime width with
    >= dim primes (at logn=14 and 15: the paths' rings, logq=438 and 881)."""
    import torch
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ring.poly import RingEngine
    logp = KERNELS[kernel]["logp"]
    key = (logp, logn) if logn in LOGQ else (logp, logn, dim)
    if key not in _RINGS:
        if logn in LOGQ:
            pctx = PolyContext(logn, 1 << LOGQ[logn], logp=logp)
        else:
            pctx = PolyContext(logn, 1 << (logp * dim), logp=logp, dim_cap=dim)
        _RINGS[key] = RingEngine(pctx, device=torch.device("cuda"))
    return _RINGS[key]


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


def bootstrap_cases(eng) -> dict:
    """The NTT shapes that the bootstrap's engine launches at its top level,
    read from it (logn=15, logq=881, slots=4, Delta=2^30): the four forward
    and three scaled inverse transforms of he_mul, the key switch's one and
    two, keygen's forward over the extended key basis, and the plain inverse
    of encryption and decryption.  First of each mode: he_mul's."""
    ctx = eng.ctx
    n, L = ctx.poly.n, ctx.L
    dim_m, dim_s = ctx.dim_mul(L), ctx.dim_swk(L)
    return {"ntt15": [("fwd", (4, dim_m, n)), ("fwd", (dim_s, n)), ("fwd", (eng.dimswk_h, n)),
                      ("inv_scaled", (3, dim_m, n)), ("inv_scaled", (2, dim_s, n)),
                      ("inv", (ctx.dim, n))]}


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


def phase_golden():
    import numpy as np
    import torch
    from gpqhe_tpu_torch import params
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.ring import sample as smp
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    with open(os.path.join(ROOT, "tests", "golden", "golden_logn11.json")) as f:
        g = {k: np.array([complex(a, b) for a, b in v]) for k, v in json.load(f).items()}
    t0 = time.time()
    ctx = HeContext(logn=11, q=1 << 48, slots=4, Delta=1 << 20)
    eng = CKKS(ctx, rng=Surf(), device=torch.device("cuda"))
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m0), pk)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct2 = eng.enc_pk(eng.ecd(m1), pk)
    if not (np.array_equal(m0, g["m0"]) and np.array_equal(m1, g["m1"])):
        raise AssertionError("surf stream diverged from the golden messages")

    def dcd(ct):
        return eng.dcd(eng.dec(ct, sk))
    tol_ks = (params.BLKSIZ + 2) / ctx.Delta
    checks = {
        "enc": (dcd(ct1), 1e-9),
        "add": (dcd(eng.add(ct1, ct2)), 1e-9),
        "mulrs": (dcd(eng.rs(eng.mul(ct1, ct2, rlk))), tol_ks),
        "conj": (dcd(eng.conj(ct1.copy(), ck)), tol_ks),
        "rot1": (dcd(eng.rot(ct1.copy(), 1, rk)), tol_ks),
        "moddown": (dcd(eng.moddown(ct1)), 1e-9),
    }
    diffs = {}
    for name, (got, tol) in checks.items():
        diffs[name] = float(np.max(np.abs(got - g[name])))
        if not diffs[name] < tol:
            raise AssertionError(f"golden {name}: diff {diffs[name]} (tol {tol})")
    emit({"phase": "golden", "diffs": diffs, "seconds": time.time() - t0})


def profile_op(op: str, fn, host_ops: bool = True, warm: bool = True, **tags) -> None:
    """One call of fn under torch.profiler: device busy time, the NTT
    kernels' share of it, the number of device kernels, and the device idle
    share of the host wall time.  host_ops=False records the device only (a
    call of some 10^5 launches would otherwise log every host operator);
    warm=False skips the call before the capture (fn has just run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not kernels or busy_us <= 0:
        emit({"phase": "profile", "op": op, **tags, "device_time": "not measured"})
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    def is_ntt(name):
        return "ntt" in name and ("_pass" in name or "_kernel" in name)
    ntt_us = sum(v for k, v in by_name.items() if is_ntt(k))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "profile", "op": op, **tags, "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy_us / 1e3,
          "idle_share": 1 - busy_us / wall_us, "device_kernels": len(kernels),
          "ntt_kernels": sum(1 for e in kernels if is_ntt(e.name)),
          "ntt_ms": ntt_us / 1e3, "ntt_share_of_busy": ntt_us / busy_us,
          "top_ms": [[k[:60], v / 1e3] for k, v in top]})


def phase_mul_rs(iters: int) -> dict:
    import numpy as np
    import torch
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.ops import ntt_cuda
    from gpqhe_tpu_torch.ring import sample as smp
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    t0 = time.time()
    ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50)
    eng = CKKS(ctx, rng=Surf(), device=torch.device("cuda"))
    eng.ring.ntt_plan(ctx.dim)         # kernel tables, outside the keygen time
    setup_s = time.time() - t0

    ntt_cuda.reset_launches()
    t1 = time.time()
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    torch.cuda.synchronize()
    keygen_s = time.time() - t1
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    m2 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m1), pk)
    ct2 = eng.enc_pk(eng.ecd(m2), pk)
    t2 = time.time()
    out = eng.mul_rs(ct1, ct2, rlk)
    torch.cuda.synchronize()
    first_ms = (time.time() - t2) * 1e3
    got = eng.dcd(eng.dec(out, sk))
    launches = dict(ntt_cuda.LAUNCHES)

    diff = float(np.max(np.abs(got - m1 * m2)))
    shape_ok = (got.shape == (ctx.slots,) and bool(np.all(np.isfinite(got)))
                and out.l == ctx.L - 1 and tuple(out.c0.shape) == (ctx.poly.n, eng.kl(ctx.L - 1)))
    ms = cuda_ms(lambda: eng.mul_rs(ct1, ct2, rlk), iters)
    profile_op("mul_rs", lambda: eng.mul_rs(ct1, ct2, rlk))
    emit({"phase": "mul_rs", "logn": 14, "logq": 438, "slots": 16, "logDelta": 50,
          "L": ctx.L, "dim_mul": ctx.dim_mul(ctx.L), "dim_swk": ctx.dim_swk(ctx.L),
          "dimswk_h": eng.dimswk_h, "kq": eng.kq, "setup_s": setup_s,
          "keygen_s": keygen_s, "first_mul_rs_ms": first_ms, "mul_rs_ms": ms,
          "decode_diff": diff, "launches": launches,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    if not shape_ok:
        raise AssertionError("mul_rs output has the wrong shape or non-finite slots")
    if not diff < 1e-5:
        raise AssertionError(f"mul_rs decode diff {diff} >= 1e-5")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the main path never launched NTT entries {missing}")
    return launches


def phase_linalg(name: str, logp: int, iters: int, earlier: dict | None) -> dict:
    """The key-switch and hoisted-gemv path at logn=14/logq=438/slots=16/
    Delta=2^50 on the logp-bit chain.  earlier: the other chain's result, to
    report the gap between the two chains' decodes.  Returns launches (NTT
    launches of the path per entry), errs ({kernel entry: max_abs_err of the
    gemv-shape comparisons}), decoded slots, and mul_rs (a closure)."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.algo import linalg
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.ops import ntt_cuda, ntt_cuda32
    from gpqhe_tpu_torch.ring import sample as smp
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    BATCH = 8
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50, logp=logp)
    eng = CKKS(ctx, rng=Surf())                  # no device given: the card
    if eng.device.type != "cuda":
        raise AssertionError(f"CKKS(ctx) chose {eng.device}, not the GPU")
    eng.ring.ntt_plan(ctx.dim)                   # kernel tables, outside the keygen time
    setup_s = time.time() - t0
    mine, other = ((ntt_cuda.LAUNCHES, ntt_cuda32.LAUNCHES32) if logp > 29
                   else (ntt_cuda32.LAUNCHES32, ntt_cuda.LAUNCHES))

    ntt_cuda.reset_launches()
    ntt_cuda32.reset_launches()
    t1 = time.time()
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    torch.cuda.synchronize()
    keygen_s = time.time() - t1

    # the vector and the matrix are the reference binary's own (tests/golden/
    # golden_algo_linear.json); on the 59-bit chain the surf stream yields
    # them at this point, and the decoded gemv is held to the binary's
    with open(os.path.join(ROOT, "tests", "golden", "golden_algo_linear.json")) as f:
        g = {k: np.array([complex(a, b) for a, b in v]) for k, v in json.load(f).items()}
    v, A = g["v"], g["A"]
    if logp == 59:
        sv = smp.sample_z01vec(eng.rng, ctx.slots)
        sA = smp.sample_z01vec(eng.rng, ctx.slots * ctx.slots)
        if not (np.array_equal(sv, v) and np.array_equal(sA, A)):
            raise AssertionError("surf stream diverged from the golden vector and matrix")
    rng = np.random.default_rng(438)
    ms = rng.random((BATCH, 2, ctx.slots)) + 1j * rng.random((BATCH, 2, ctx.slots))
    m2 = ms[0, 1]

    def dcd(c):
        return eng.dcd(eng.dec(c, sk))
    ct = eng.enc_pk(eng.ecd(v), pk)
    ct2 = eng.enc_pk(eng.ecd(m2), pk)
    plan = linalg.HoistedGemvPlan(eng, A)
    bank = {r: rk[r] for r in rk if r < plan.n1 or r % plan.n1 == 0}
    Av = A.reshape(ctx.slots, ctx.slots) @ v

    out = {"mul_rs": eng.mul_rs(ct, ct2, rlk), "rot": eng.rot(ct, 1, rk),
           "conj": eng.conj(ct, ck), "mulpt": eng.rs(eng.mulpt(ct, eng.ecd(m2)))}
    want = {"mul_rs": v * m2, "rot": np.roll(v, -1), "conj": np.conj(v),
            "mulpt": v * m2, "gemv_full": Av, "gemv_bsgs": Av}
    cts1 = [eng.enc_pk(eng.ecd(m[0]), pk) for m in ms]
    cts2 = [eng.enc_pk(eng.ecd(m[1]), pk) for m in ms]
    batch = eng.mul_rs_batch(cts1, cts2, rlk)
    singles = [eng.mul_rs(a, b, rlk) for a, b in zip(cts1, cts2)]
    batch_equal = all(torch.equal(x.c0, y.c0) and torch.equal(x.c1, y.c1)
                      and (x.l, x.nu, x.B) == (y.l, y.nu, y.B)
                      for x, y in zip(batch, singles))
    out["batch7"], want["batch7"] = batch[-1], ms[-1, 0] * ms[-1, 1]
    out["gemv_full"] = linalg.gemv(eng, None, ct, rk, plan=plan, hoisted=True)
    full_route = linalg.gemv_hoisted_full(eng, plan, ct, rk) is not None
    bank_full_route = linalg.gemv_hoisted_full(eng, plan, ct, bank) is not None
    out["gemv_bsgs"] = linalg.gemv_hoisted(eng, plan, ct, bank)
    got = {k: dcd(c) for k, c in out.items()}
    torch.cuda.synchronize()
    launches, foreign = dict(mine), dict(other)

    diffs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in got}
    golden_gemv = (float(np.max(np.abs(got["gemv_full"] - g["gemv"])))
                   if logp == 59 else None)
    gap = None
    if earlier is not None:
        gap = {k: float(np.max(np.abs(got[k] - earlier["decoded"][k])))
               for k in ("mul_rs", "gemv_full", "gemv_bsgs")}

    l = ct.l
    dims_full = eng.gemv_dims(l, plan.bound_max_full(eng) * ctx.slots)
    dims_bsgs = plan.dims(eng, l)[:2]
    few = max(3, iters // 4)
    times = {
        "mul_rs_ms": cuda_ms(lambda: eng.mul_rs(ct, ct2, rlk), few),
        "rot_ms": cuda_ms(lambda: eng.rot(ct, 1, rk), few),
        "conj_ms": cuda_ms(lambda: eng.conj(ct, ck), few),
        "mul_rs_batch_ms_per_ct": cuda_ms(lambda: eng.mul_rs_batch(cts1, cts2, rlk), few) / BATCH,
        "gemv_full_ms": cuda_ms(lambda: linalg.gemv_hoisted(eng, plan, ct, rk), few),
        "gemv_bsgs_ms": cuda_ms(lambda: linalg.gemv_hoisted(eng, plan, ct, bank), few),
    }
    for op, fn in (("rot", lambda: eng.rot(ct, 1, rk)),
                   ("mul_rs_batch8", lambda: eng.mul_rs_batch(cts1, cts2, rlk)),
                   ("gemv_full", lambda: linalg.gemv_hoisted(eng, plan, ct, rk)),
                   ("gemv_bsgs", lambda: linalg.gemv_hoisted(eng, plan, ct, bank))):
        profile_op(op, fn, logp=logp)
    emit({"phase": name, "logp": logp, "logn": 14, "logq": 438, "slots": 16,
          "logDelta": 50, "L": ctx.L, "dimub": ctx.poly.dimub, "dim": ctx.dim,
          "dim_mul": ctx.dim_mul(ctx.L), "dim_swk": ctx.dim_swk(ctx.L),
          "dimswk_h": eng.dimswk_h, "gemv_dims_full": list(dims_full),
          "gemv_dims_bsgs": list(dims_bsgs), "n1": plan.n1, "n2": plan.n2,
          "setup_s": setup_s, "keygen_s": keygen_s, **times,
          "decode_diffs": diffs, "golden_gemv_diff": golden_gemv,
          "batch_equals_mul_rs": batch_equal, "fallbacks": plan.fallbacks,
          "chain_gap": gap, "launches": launches, "other_kernel_launches": foreign,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})

    bad = {k: d for k, d in diffs.items() if not d < 1e-5}
    if bad:
        raise AssertionError(f"{name}: decode diffs {bad} >= 1e-5")
    if golden_gemv is not None and not golden_gemv < 1e-9:
        raise AssertionError(f"{name}: gemv is {golden_gemv} from the reference binary's")
    if not batch_equal:
        raise AssertionError(f"{name}: mul_rs_batch differs from mul_rs")
    if plan.fallbacks != 0 or not full_route or bank_full_route:
        raise AssertionError(f"{name}: gemv routes: fallbacks={plan.fallbacks}, "
                             f"full={full_route}, full on the restricted bank={bank_full_route}")
    if any(c <= 0 for c in launches.values()) or any(foreign.values()):
        raise AssertionError(f"{name}: NTT launches {launches}, other kernel {foreign}")
    if gap is not None and not all(d < 1e-9 for d in gap.values()):
        raise AssertionError(f"{name}: the two chains decode {gap} apart")

    # the kernel at the gemv's shapes, against its twin
    kernel = "ntt" if logp > 29 else "ntt32"
    n = ctx.poly.n
    rng = np.random.default_rng(logp)
    errs = {}
    for dims_h, dimc in {tuple(dims_full), tuple(dims_bsgs)}:
        for mode, shape in (("fwd", (dims_h, n)), ("fwd", (dimc, n)),
                            ("inv_scaled", (2, dims_h, n)), ("inv_scaled", (dimc, n))):
            r = compare_kernel(kernel, mode, shape, few, rng)
            key = f"{kernel}_{mode}"
            errs[key] = max(errs.get(key, 0), r["max_abs_err"])
    return {"launches": launches, "errs": errs, "decoded": got,
            "mul_rs": lambda: eng.mul_rs(ct, ct2, rlk), "keys": (eng, pk, sk, rlk, ck, rk)}


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


def mesh_coeff_ntt_check(logp: int, devices) -> dict:
    """_ntt_coeff_sharded over S = 2, 4, 8 coefficient shards at [16, 2^14]
    against the single-device kernel NTT; the inverse gives the input back."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.parallel import mesh as pm
    kernel = "ntt" if logp > 29 else "ntt32"
    ring = kernel_ring(kernel, 14, 16)
    pctx, dim = ring.pctx, 16
    ps = np.array(pctx.primes[:dim], dtype=np.uint64)
    host = (np.random.default_rng(logp).integers(0, 1 << 62, (dim, N14), dtype=np.uint64)
            % ps[:, None]).astype(np.int64)
    a = torch.from_numpy(host).to(ring.device)
    want = ring.ntt_f(a, dim)
    out = {}
    for S in (2, 4, 8):
        mesh = pm.make_he_mesh3(S, limb=1, coeff=S,
                                devices=None if devices is None else devices[:S])
        splan, C = pm._basis_consts(mesh, pctx, dim, 14, "a")
        hat = pm._ntt_coeff_sharded(mesh, pm._scatter(mesh, a, (None, "coeff")), C, "a", splan)
        back = pm._gather(mesh, pm._intt_coeff_sharded(mesh, hat, C, "a", splan),
                          (None, "coeff"))
        torch.cuda.synchronize()
        out[S] = {"forward_equal": bool(torch.equal(pm._gather(mesh, hat, (None, "coeff")), want)),
                  "roundtrip_equal": bool(torch.equal(back, a)),
                  "block_swaps": mesh.traffic["ppermute"][0]}
    emit({"phase": "mesh_coeff_ntt", "logp": logp, "shape": [dim, N14], "shards": out})
    if not all(v["forward_equal"] and v["roundtrip_equal"] for v in out.values()):
        raise AssertionError(f"coefficient-sharded NTT, logp={logp}: {out}")
    return out


def mesh_chain(logp: int, iters: int, devices, what: str) -> dict:
    """mul_rs, rot(1), conj and the fully hoisted gemv at logn=14/logq=438/
    slots=16/Delta=2^50 on a (2,2,2) mesh against the single-device engine
    on the same keys.  Returns the NTT launches of one call of each mesh op."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.algo import linalg
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.parallel.engine import MeshCKKS
    from gpqhe_tpu_torch.parallel.mesh import make_he_mesh3
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50, logp=logp)
    eng = CKKS(ctx, rng=Surf())
    mesh = make_he_mesh3(8, limb=2, coeff=2, devices=devices)
    meng = MeshCKKS(ctx, mesh, rng=Surf())
    if meng.device.type != "cuda":
        raise AssertionError(f"MeshCKKS chose {meng.device}, not the GPU")
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    rng = np.random.default_rng(438)
    v = rng.random(ctx.slots) + 1j * rng.random(ctx.slots)
    m2 = rng.random(ctx.slots) + 1j * rng.random(ctx.slots)
    A = rng.random(ctx.slots * ctx.slots) + 1j * rng.random(ctx.slots * ctx.slots)
    ct, ct2 = eng.enc_pk(eng.ecd(v), pk), eng.enc_pk(eng.ecd(m2), pk)
    plans = {e: linalg.HoistedGemvPlan(e, A) for e in (eng, meng)}

    def ops(e):
        return {"mul_rs": lambda: e.mul_rs(ct, ct2, rlk), "rot": lambda: e.rot(ct, 1, rk),
                "conj": lambda: e.conj(ct, ck),
                "gemv_full": lambda: linalg.gemv_hoisted_full(e, plans[e], ct, rk)}
    want = {"mul_rs": v * m2, "rot": np.roll(v, -1), "conj": np.conj(v),
            "gemv_full": A.reshape(ctx.slots, ctx.slots) @ v}
    t1 = time.time()
    single = {k: fn() for k, fn in ops(eng).items()}
    sharded = {k: fn() for k, fn in ops(meng).items()}        # builds the sharded programs
    torch.cuda.synchronize()
    first_s = time.time() - t1
    equal = {k: bool(torch.equal(single[k].c0, sharded[k].c0)
                     and torch.equal(single[k].c1, sharded[k].c1)
                     and (single[k].l, single[k].nu, single[k].B)
                     == (sharded[k].l, sharded[k].nu, sharded[k].B)) for k in single}
    diffs = {k: float(np.max(np.abs(eng.dcd(eng.dec(c, sk)) - want[k])))
             for k, c in sharded.items()}

    # the mesh engine's main path: one call of each mesh op, programs built,
    # the counters zeroed just before and read just after
    mine, other = chain_counters(logp)
    traffic = {}
    for k, fn in ops(meng).items():
        mesh.reset_traffic()
        fn()
        traffic[k] = {kind: list(c) for kind, c in mesh.traffic.items()}
    torch.cuda.synchronize()
    launches, foreign = dict(mine), dict(other)
    P = len(mesh.positions)
    # a position: mul_rs 2 forward (four ciphertext polys in one launch, d2) and
    # 2 inverse (three cross terms, two key-switch halves); rot and conj 1 + 1;
    # the gemv step 2 inverse, its prologue 2 forward on the first device
    expected = {"fwd": 2 * P + P + P + 2, "inv": 2 * P + P + P + 2 * P, "inv_scaled": 0}

    few = max(3, iters // 4)
    ms = {"single": {k: cuda_ms(fn, few) for k, fn in ops(eng).items()},
          "mesh": {k: cuda_ms(fn, few, warmup=1) for k, fn in ops(meng).items()}}
    for k, fn in ops(meng).items():
        profile_op(k, fn, host_ops=False, warm=False, logp=logp, mesh=[2, 2, 2])
    l = ct.l
    emit({"phase": "mesh", "logp": logp, "logn": 14, "logq": 438, "slots": 16, "logDelta": 50,
          "mesh": dict(mesh.shape), "devices": what, "L": ctx.L,
          "dim_mul_padded": meng._pad_limb(ctx.dim_mul(l)),
          "dim_swk_padded": meng._pad_limb(ctx.dim_swk(l)), "dimswk_h": eng.dimswk_h,
          "gemv_dims": list(meng.gemv_dims(l, plans[meng].bound_max_full(meng) * ctx.slots)),
          "keygen_s": keygen_s, "first_calls_s": first_s, "ms": ms,
          "slowdown": {k: ms["mesh"][k] / ms["single"][k] for k in ms["mesh"]},
          "equal_to_single_device": equal, "decode_diffs": diffs,
          "fallbacks": {"single": plans[eng].fallbacks, "mesh": plans[meng].fallbacks},
          "programs": sorted(str(k) for k in meng._mesh_jit),
          "launches": launches, "expected_launches": expected,
          "other_kernel_launches": foreign, "transfers_and_bytes": traffic,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    if not all(equal.values()):
        raise AssertionError(f"mesh logp={logp}: differs from the single-device engine: {equal}")
    bad = {k: d for k, d in diffs.items() if not d < 1e-5}
    if bad:
        raise AssertionError(f"mesh logp={logp}: decode diffs {bad} >= 1e-5")
    if plans[eng].fallbacks or plans[meng].fallbacks or not meng._mesh_jit:
        raise AssertionError(f"mesh logp={logp}: gemv fell back, or no sharded program was built")
    if launches != expected or any(foreign.values()):
        raise AssertionError(f"mesh logp={logp}: NTT launches {launches}, expected {expected}; "
                             f"other kernel {foreign}")
    return launches


def mixed_devices(card, limb: int, coeff: int, batch: int) -> list:
    """Devices of a (limb, coeff, batch) mesh whose position (l, c, b) is on
    the card when l + c is even and on the host otherwise: every limb psum
    and every coefficient swap (partners differ by one in l or in c) is a
    copy between the two, and so is half of every scatter and gather."""
    import torch
    return [card if (l + c) % 2 == 0 else torch.device("cpu")
            for l in range(limb) for c in range(coeff) for _ in range(batch)]


def first_difference(a, b):
    """The first index at which two tensors differ (None where equal)."""
    import torch
    if a.shape != b.shape:
        return f"shapes {tuple(a.shape)} and {tuple(b.shape)}"
    diff = torch.nonzero(a.cpu() != b.cpu())
    return tuple(diff[0].tolist()) if len(diff) else None


def mesh_mixed(logp: int) -> None:
    """The copy path: mul_rs, rot(1), conj and the fully hoisted gemv at
    logn=9/logq=120/slots=4/Delta=2^30 on a (2,2,2) mesh of the card and the
    host (mixed_devices) against CKKS on the card, on the same keys."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.algo import linalg
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.parallel.engine import MeshCKKS
    from gpqhe_tpu_torch.parallel.mesh import make_he_mesh3
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    t0 = time.time()
    ctx = HeContext(logn=9, q=1 << 120, slots=4, Delta=1 << 30, logp=logp)
    eng = CKKS(ctx, rng=Surf(), hoist_bits=100)
    pk, sk = eng.keypair()
    rlk, ck, rk = eng.genrlk(sk), eng.genck(sk), eng.genrk(sk)
    rng = np.random.default_rng(9)
    v, m2 = (rng.random(4) + 1j * rng.random(4) for _ in range(2))
    A = rng.random(16) + 1j * rng.random(16)
    ct, ct2 = eng.enc_pk(eng.ecd(v), pk), eng.enc_pk(eng.ecd(m2), pk)
    mesh = make_he_mesh3(8, limb=2, coeff=2,
                         devices=mixed_devices(torch.device("cuda", 0), 2, 2, 2))
    meng = MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=100)

    def ops(e):
        plan = linalg.HoistedGemvPlan(e, A)
        return {"mul_rs": lambda: e.mul_rs(ct, ct2, rlk), "rot": lambda: e.rot(ct, 1, rk),
                "conj": lambda: e.conj(ct, ck),
                "gemv_full": lambda: linalg.gemv_hoisted_full(e, plan, ct, rk)}
    single = {k: fn() for k, fn in ops(eng).items()}
    got, traffic = {}, {}
    for k, fn in ops(meng).items():
        mesh.reset_traffic()
        got[k] = fn()
        traffic[k] = {c: {kind: list(n) for kind, n in kinds.items()}
                      for c, kinds in mesh.traffic_by_kind.items()}
    torch.cuda.synchronize()
    differ = {f"{k} {half}": first_difference(getattr(got[k], half), getattr(single[k], half))
              for k in single if got[k] is not None for half in ("c0", "c1")}
    equal = {k: got[k] is not None and differ[f"{k} c0"] is None and differ[f"{k} c1"] is None
             and (got[k].l, got[k].nu, got[k].B) == (single[k].l, single[k].nu, single[k].B)
             for k in single}
    copies = {c: sum(t[c]["device"][1] for t in traffic.values()) for c in traffic["mul_rs"]}
    views_due_copies = {c: sum(t[c]["view"][0] for t in traffic.values())
                        for c in ("psum", "ppermute")}
    emit({"phase": "mesh_mixed", "logp": logp, "logn": 9, "logq": 120, "slots": 4,
          "logDelta": 30, "mesh": dict(mesh.shape),
          "devices": [str(mesh.device(p)) for p in mesh.positions],
          "equal_to_single_device": equal, "first_difference": differ,
          "device_copy_bytes": copies, "views_in_psum_and_ppermute": views_due_copies,
          "traffic": traffic, "seconds": time.time() - t0})
    if not all(equal.values()):
        raise AssertionError(f"mixed mesh logp={logp}: differs from the card: {differ}")
    if not all(copies.values()) or any(views_due_copies.values()):
        raise AssertionError(f"mixed mesh logp={logp}: copies {copies}, views where a copy "
                             f"was due {views_due_copies}")


MP_RING = ["--logn=14", "--logq=438", "--slots=16", "--logDelta=50"]
MP_LAYOUTS = ("2x2x2", "1x4x2")


def phase_mesh_mp(iters: int) -> None:
    """The mesh across two processes (gpqhe_tpu_torch.parallel.mp_mul_rs) at
    logn=14/logq=438/slots=16/Delta=2^50 on both chains and both layouts in
    one launcher run: 2 ranks x 4 positions, both on the one card over gloo
    (or one card a rank over nccl where there are two).  One line a chain."""
    import torch
    cards = torch.cuda.device_count()
    backend, why = (("nccl", f"{cards} cards: one a rank") if cards >= 2 else
                    ("gloo", "one card: both ranks share it, which nccl refuses; gloo "
                             "stages every message through host memory"))
    t0 = time.time()
    argv = [sys.executable, "-m", "gpqhe_tpu_torch.parallel.mp_mul_rs", "--device=cuda",
            f"--backend={backend}", *MP_RING, "--logp=59,29",
            f"--mesh={','.join(MP_LAYOUTS)}", f"--iters={iters}", "--timeout=600"]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=900)
    stdout = out.stdout.splitlines()
    lines = [json.loads(t) for t in stdout if t.startswith("{")]
    problems = []
    if out.returncode != 0 or not stdout or not stdout[-1].startswith("mp_mul_rs: PASS"):
        problems.append(f"exit {out.returncode}")
    for logp in (59, 29):
        mine, other = ("u64", "u32") if logp > 29 else ("u32", "u64")
        ranks = {}
        for ln in lines:
            if ln["logp"] != logp:
                continue
            kinds = {op: {k: sum(c[k][1] for c in t.values())
                          for k in ("view", "device", "process", "staged")}
                     for op, t in ln["traffic"].items()}
            ranks.setdefault(ln["mesh"], []).append({
                "rank": ln["rank"], "positions": ln["positions"], "equal": ln["equal"],
                "decode_diffs": ln["decode_diffs"], "ms": ln.get("ms"),
                "mul_rs_busy_ms": ln.get("mul_rs_busy_ms"), "virtual": ln.get("virtual"),
                "bytes_by_kind": kinds,
                "mul_rs_bytes": {c: {k: v[1] for k, v in t.items()}
                                 for c, t in ln["traffic"]["mul_rs"].items()},
                "launches": ln["launches"], "first_calls_s": ln["first_calls_s"],
                "setup_s": ln["setup_s"], "seconds": ln["seconds"],
                "peak_mem_mb": ln.get("peak_mem_mb")})
        emit({"phase": "mesh_mp", "logp": logp, "logn": 14, "logq": 438, "slots": 16,
              "logDelta": 50, "backend": backend, "why": why, "ranks": 2,
              "returncode": out.returncode, "verdict": stdout[-1] if stdout else None,
              "layouts": ranks, "seconds": time.time() - t0})
        if sorted(ranks) != sorted(MP_LAYOUTS) or any(len(v) != 2 for v in ranks.values()):
            problems.append(f"logp={logp} rank lines "
                            f"{[(ln['mesh'], ln['rank']) for ln in lines if ln['logp'] == logp]}")
        for lay, rs in ranks.items():
            for r in rs:
                where = f"logp={logp} {lay} rank {r['rank']}"
                if not all(r["equal"].values()) or not all(d < 1e-5 for d in r["decode_diffs"].values()):
                    problems.append(f"{where}: {r['equal']} {r['decode_diffs']}")
                if (r["launches"][mine]["fwd"] <= 0 or r["launches"][mine]["inv"] <= 0
                        or any(r["launches"][other].values())):
                    problems.append(f"{where}: launches {r['launches']}")
                if backend == "gloo" and not sum(k["staged"] for k in r["bytes_by_kind"].values()):
                    problems.append(f"{where}: nothing staged over gloo")
            if not sum(k["process"] for r in rs for k in r["bytes_by_kind"].values()):
                problems.append(f"logp={logp} {lay}: no bytes crossed the processes")
    if problems:
        raise AssertionError(f"mesh_mp: {problems}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")


def mesh_cli() -> None:
    """`mul pk --mesh=2x2x1:virtual` at its defaults on the card, and the
    same mesh without :virtual (at a small ring: the answer does not depend
    on it), which a machine with fewer than 4 GPUs must refuse."""
    import torch
    small = ["--logn=9", "--logq=120", "--slots=4", "--logDelta=30"]
    for argv, want_rc in ((["mul", "pk", "--mesh=2x2x1:virtual"], 0),
                          (["mul", "pk", "--mesh=2x2x1"] + small,
                           0 if torch.cuda.device_count() >= 4 else 2)):
        t0 = time.time()
        out = subprocess.run([sys.executable, "-m", "gpqhe_tpu_torch"] + argv, cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        lines = out.stdout.splitlines()
        oks = [ln for ln in lines if ln.startswith("[ok] ")]
        said = [ln for ln in lines if ln.startswith(("mesh mode: ", "--mesh="))]
        emit({"phase": "mesh_cli", "argv": argv, "returncode": out.returncode,
              "ok_lines": oks, "said": said, "seconds": time.time() - t0})
        good = (out.returncode == 0 and oks and said[:1] == ["mesh mode: {'limb': 2, "
                "'coeff': 2, 'batch': 1}"]) if want_rc == 0 else (
            out.returncode == 2 and not oks and said and "needs 4 devices" in said[0])
        if not good:
            raise AssertionError(f"cli {argv}: exit {out.returncode}\n{out.stdout[-2000:]}"
                                 f"\n{out.stderr[-2000:]}")


def phase_mesh(iters: int) -> dict:
    """The logn=14 part of the mesh phase.  Returns the kernel numbers on
    the per-shard plans and the launches of the mesh ops' main-path run."""
    import numpy as np
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.parallel.mesh import make_he_mesh3
    devices, what = mesh_devices(8)
    rng = np.random.default_rng(5)
    kernels, launches = {}, {}
    for kernel, logp in (("nttmesh", 59), ("ntt32mesh", 29)):
        meshes = {S: make_he_mesh3(2 * S, limb=2, coeff=S,
                                   devices=None if devices is None else devices[:2 * S])
                  for S in (2, 4)}
        ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50, logp=logp)
        pctx = kernel_ring(KERNELS[kernel]["lib"], 14, 16).pctx
        dim_m = ctx.dim_mul(ctx.L) + ctx.dim_mul(ctx.L) % 2      # padded to the limb axis
        dim_s = ctx.dim_swk(ctx.L) + ctx.dim_swk(ctx.L) % 2
        # n/S = 2^13: the shapes mul_rs launches on the (2,2,2) mesh
        r = mesh_kernel_entry(kernel, pctx, meshes[2], dim_m, 14,
                              [("fwd", (4, 1)), ("inv", (3, 1))], iters, rng)
        mesh_kernel_entry(kernel, pctx, meshes[2], dim_s, 14,
                          [("fwd", (1,)), ("inv", (2, 1))], iters, rng, report=False)
        # n/S = 2^12
        mesh_kernel_entry(kernel, pctx, meshes[4], dim_m, 14,
                          [("fwd", (4, 1)), ("inv", (3, 1))], iters, rng, report=False)
        kernels.update({f"{kernel}_{mode}": v for mode, v in r.items()})
        mesh_coeff_ntt_check(logp, devices)
        got = mesh_chain(logp, iters, devices, what)
        launches.update({f"{kernel}_{mode}": got[mode] for mode in r})
        mesh_mixed(logp)
    mesh_cli()
    return {"kernels": kernels, "launches": launches}


def phase_mesh_compose(iters: int, o: dict | None) -> dict:
    """bootstrap.coeff2slot at logn=15/logq=881/slots=4/Delta=2^30 on a
    (2,4,1) mesh against the single-device engine, on the bootstrap phase's
    engine and keys (o), or on its own where that phase did not run; before
    it the u64 kernel on this mesh's per-shard plans (n/S = 2^13)."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch import bootstrap as bs
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.parallel.engine import MeshCKKS
    from gpqhe_tpu_torch.parallel.mesh import make_he_mesh3
    from gpqhe_tpu_torch.ring import sample as smp
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    torch.cuda.reset_peak_memory_stats()
    devices, what = mesh_devices(8)
    if o is None:
        ctx = HeContext(logn=15, q=1 << LOGQ[15], slots=4, Delta=1 << 30)
        eng = CKKS(ctx, rng=Surf())
        pk, sk = eng.keypair()
        o = dict(ctx=ctx, eng=eng, sk=sk, ck=eng.genck(sk),
                 rk=eng.genrk(sk, bs.bootstrap_rotations(ctx)),
                 ct=eng.enc_pk(eng.ecd(smp.sample_z01vec(eng.rng, ctx.slots) * 0.1), pk))
    ctx, eng, ct, ck, rk = o["ctx"], o["eng"], o["ct"], o["ck"], o["rk"]
    l = ct.l
    dim_s = ctx.dim_swk(l) + ctx.dim_swk(l) % 2
    mesh = make_he_mesh3(8, limb=2, coeff=4, devices=devices)      # batch=1: one ciphertext
    # no split by pass here: after the bootstrap phase's captures of some
    # 10^5 kernels the profiler returns only part of a short capture's events
    kernels = mesh_kernel_entry("ntt15mesh", ctx.poly, mesh, dim_s, eng.kl(l),
                                [("fwd", (1,)), ("inv", (2, 1))], iters,
                                np.random.default_rng(15), breakdown=False)
    meng = MeshCKKS(ctx, mesh, rng=Surf())

    def run(e, bctx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bs.coeff2slot(e, bctx, ct, ck, rk)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    bctx_s, bctx_m = bs.BootstrapContext(eng), bs.BootstrapContext(meng)
    (s0, s1), _ = run(eng, bctx_s)
    mine, other = chain_counters(59)
    (m0, m1), first_s = run(meng, bctx_m)                 # builds tables and programs
    launches, foreign = dict(mine), dict(other)
    equal = all(torch.equal(a, b) for a, b in ((s0.c0, m0.c0), (s0.c1, m0.c1),
                                               (s1.c0, m1.c0), (s1.c1, m1.c1)))
    mesh.reset_traffic()
    _, mesh_s = run(meng, bctx_m)
    traffic = {kind: list(c) for kind, c in mesh.traffic.items()}
    _, single_s = run(eng, bctx_s)
    profile_op("coeff2slot", lambda: bs.coeff2slot(meng, bctx_m, ct, ck, rk), host_ops=False,
               warm=False, mesh=[2, 4, 1])
    emit({"phase": "mesh_compose", "logn": 15, "logq": LOGQ[15], "slots": 4, "logDelta": 30,
          "mesh": dict(mesh.shape), "devices": what, "level": l,
          "equal_to_single_device": equal, "first_call_s": first_s, "mesh_s": mesh_s,
          "single_s": single_s, "slowdown": mesh_s / single_s,
          "programs": sorted(str(k) for k in meng._mesh_jit),
          "fallbacks": {name: plan.fallbacks for name, plan in bctx_m._plans.items()},
          "launches_first_call": launches, "other_kernel_launches": foreign,
          "transfers_and_bytes": traffic,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    if not equal:
        raise AssertionError("coeff2slot on the mesh differs from the single-device engine")
    if not meng._mesh_jit or launches["fwd"] <= 0 or launches["inv"] <= 0 or any(foreign.values()):
        raise AssertionError(f"coeff2slot on the mesh: programs {list(meng._mesh_jit)}, "
                             f"NTT launches {launches}, other kernel {foreign}")
    return {"kernels": {f"ntt15mesh_{mode}": v for mode, v in kernels.items()},
            "launches": {f"ntt15mesh_{mode}": launches[mode] for mode in kernels}}


def load_golden(name: str) -> dict:
    import numpy as np
    with open(os.path.join(ROOT, "tests", "golden", name)) as f:
        return {k: np.array([complex(a, b) for a, b in v]) for k, v in json.load(f).items()}


def wall_s(fn, iters: int) -> float:
    """Median seconds of fn() on the host's clock, each run ended by a
    device synchronise (for calls of seconds, where events add nothing)."""
    import torch
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return median(times)


def chain_counters(logp: int):
    """(this chain's launch counters, the other kernel's)."""
    from gpqhe_tpu_torch.ops import ntt_cuda, ntt_cuda32
    ntt_cuda.reset_launches()
    ntt_cuda32.reset_launches()
    return ((ntt_cuda.LAUNCHES, ntt_cuda32.LAUNCHES32) if logp > 29
            else (ntt_cuda32.LAUNCHES32, ntt_cuda.LAUNCHES))


def require_launches(name: str, mine: dict, other: dict) -> None:
    if any(c <= 0 for c in mine.values()) or any(other.values()):
        raise AssertionError(f"{name}: NTT launches {dict(mine)}, other kernel {dict(other)}")


def phase_nonlinear(iters: int) -> None:
    """algo/nonlinear.py at logn=14/logq=438/slots=4/Delta=2^30 on each
    chain: the reference binary's KAT on the 59-bit chain (its op sequence,
    tests/test_golden_algo.py), the plaintext functions on logp=29."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.algo import nonlinear as nl
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.ring import sample as smp
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    g = load_golden("golden_algo_nonlinear.json")
    a = 2j * np.pi / float(1 << 30)
    for logp in (59, 29):
        t0 = time.time()
        ctx = HeContext(logn=14, q=1 << 438, slots=4, Delta=1 << 30, logp=logp)
        eng = CKKS(ctx, rng=Surf())
        mine, other = chain_counters(logp)
        pk, sk = eng.keypair()
        rlk = eng.genrlk(sk)
        torch.cuda.synchronize()
        keygen_s = time.time() - t0
        # the binary's message: the surf stream yields it here on the 59-bit
        # chain (the other chain's keys draw another number of bytes)
        m0 = smp.sample_z01vec(eng.rng, ctx.slots)
        if logp == 59 and not np.array_equal(m0, g["m0"]):
            raise AssertionError("surf stream diverged from the golden message m0")
        m0 = g["m0"]
        msgs = {"inv": m0.real + 0.5, "exp": m0 * a, "sigmoid": m0 / 10,
                "log": m0.real / 100000, "sqrt": m0.real + 0j}
        cts = {k: eng.enc_pk(eng.ecd(np.asarray(v, dtype=np.complex128)), pk)
               for k, v in msgs.items()}
        ops = {"inv": lambda: nl.he_inv(eng, cts["inv"], rlk, 5),
               "exp": lambda: nl.he_exp(eng, a, cts["exp"], rlk, 5),
               "sigmoid": lambda: nl.he_sigmoid(eng, cts["sigmoid"], rlk),
               "log": lambda: nl.he_log(eng, cts["log"], rlk),
               "sqrt": lambda: nl.he_sqrt(eng, cts["sqrt"], rlk, 6)}
        # the plaintext functions and the per-op CLI's tolerances (cli.py);
        # inv by the evaluator's own Goldschmidt recurrence, as there
        an, bn = 2 - msgs["inv"], 1 - msgs["inv"]
        for _ in range(5):
            bn = bn * bn
            an = an * (bn + 1)
        plain = {"inv": (an, 1e-4), "exp": (np.exp(a * msgs["exp"]), 1e-4),
                 "sigmoid": (1 / (1 + np.exp(-msgs["sigmoid"])), 1e-3),
                 "log": (np.log(1 + msgs["log"]), 1e-2), "sqrt": (np.sqrt(msgs["sqrt"]), 1e-2)}
        outs = {k: fn() for k, fn in ops.items()}
        got = {k: eng.dcd(eng.dec(c, sk)) for k, c in outs.items()}
        torch.cuda.synchronize()
        launches, foreign = dict(mine), dict(other)
        # the reference binary ran the 59-bit chain: its outputs gate that
        # chain at 1e-4 (tests/test_golden_algo.py) and are reported beside
        # the other; logp=29 is gated by the plaintext functions
        golden = {k: float(np.max(np.abs(got[k] - g[k]))) for k in ops}
        model = {k: float(np.max(np.abs(got[k] - plain[k][0]))) for k in ops}
        ms = {k: wall_s(fn, max(1, iters // 10)) * 1e3 for k, fn in ops.items()}
        for k, fn in ops.items():
            profile_op("he_" + k, fn, host_ops=False, warm=False, logp=logp)
        emit({"phase": "nonlinear", "logp": logp, "logn": 14, "logq": 438, "slots": 4,
              "logDelta": 30, "L": ctx.L, "keygen_s": keygen_s, "op_ms": ms,
              "levels_used": {k: ctx.L - c.l for k, c in outs.items()},
              "golden_diffs": golden, "plain_diffs": model, "launches": launches,
              "other_kernel_launches": foreign,
              "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
        if logp == 59:
            bad = {k: d for k, d in golden.items() if not d < 1e-4}
        else:
            bad = {k: d for k, d in model.items() if not d < plain[k][1]}
        if bad:
            raise AssertionError(f"nonlinear logp={logp}: diffs {bad} over the gate")
        require_launches(f"nonlinear logp={logp}", launches, foreign)


def phase_cmp(iters: int) -> None:
    """he_cmp at logn=15/logq=881/slots=4/Delta=2^30, iter=5, alpha=2
    (tests/test_golden_algo.py::test_golden_algo_cmp)."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.algo import nonlinear as nl
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.ring import sample as smp
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    g = load_golden("golden_algo_cmp.json")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = HeContext(logn=15, q=1 << LOGQ[15], slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    mine, other = chain_counters(59)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    torch.cuda.synchronize()
    keygen_s = time.time() - t0
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)      # sampled twice (ref: tests/gpqhe.c:1041)
    if not np.array_equal(m0, g["m0"]):
        raise AssertionError("surf stream diverged from the golden message m0")
    ma, mb = m0.real + 0.5, m0.imag + 0.5
    ct1 = eng.enc_pk(eng.ecd(np.asarray(ma, dtype=np.complex128)), pk)
    ct2 = eng.enc_pk(eng.ecd(np.asarray(mb, dtype=np.complex128)), pk)

    def run():
        return nl.he_cmp(eng, ct1, ct2, rlk, iter=5, alpha=2)
    out = run()
    got = eng.dcd(eng.dec(out, sk))
    torch.cuda.synchronize()
    launches, foreign = dict(mine), dict(other)
    diff = float(np.max(np.abs(got - g["cmp"])))
    bits_ok = bool(np.array_equal(np.round(got.real), (ma > mb).astype(float)))
    profile_op("he_cmp", run, host_ops=False, warm=False)
    emit({"phase": "cmp", "logn": 15, "logq": LOGQ[15], "slots": 4, "logDelta": 30, "iter": 5,
          "alpha": 2, "L": ctx.L, "levels_used": ctx.L - out.l, "keygen_s": keygen_s,
          "cmp_s": wall_s(run, max(1, iters // 10)), "golden_diff": diff,
          "decision_bits_equal": bits_ok, "launches": launches,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    if not diff < 1e-4:
        raise AssertionError(f"cmp is {diff} from the reference binary's (gate 1e-4)")
    if not bits_ok:
        raise AssertionError("cmp decision bits differ from the plaintext comparison")
    require_launches("cmp", launches, foreign)


class StageClock:
    """Seconds per bootstrap stage of one call: wraps the bootstrap module's
    stage functions for the duration so that each synchronises the device
    and notes the host clock on entry and exit."""
    NAMES = ("raise_modulus", "subsum", "coeff2slot", "_exp_small_a", "slot2coeff")

    def __init__(self, module):
        self.module, self.marks, self._saved = module, [], {}

    def __enter__(self):
        import torch
        for name in self.NAMES:
            fn = self._saved[name] = getattr(self.module, name)

            def timed(*args, _fn=fn, _name=name, **kw):
                torch.cuda.synchronize()
                self.marks.append((_name, "in", time.perf_counter()))
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                self.marks.append((_name, "out", time.perf_counter()))
                return out
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.module, name, fn)

    def stages(self, t_end: float) -> dict:
        """raise, SubSum, coeff2slot without its SubSum, each mod_reduce
        (from its exp's entry to the next stage's), slot2coeff."""
        t = {}
        for name, edge, at in self.marks:
            t.setdefault((name, edge), []).append(at)

        def span(name, i=0):
            return t[name, "out"][i] - t[name, "in"][i]
        exp_in = t["_exp_small_a", "in"]
        return {"raise": span("raise_modulus"), "subsum": span("subsum"),
                "coeff2slot": span("coeff2slot") - span("subsum"),
                "mod_reduce": [exp_in[1] - exp_in[0], t["slot2coeff", "in"][0] - exp_in[1]],
                "exp_of_mod_reduce": [span("_exp_small_a", 0), span("_exp_small_a", 1)],
                "slot2coeff": span("slot2coeff"),
                "end": t_end - t["slot2coeff", "out"][0]}


def phase_bootstrap(iters: int) -> dict:
    """The deep-circuit main path at full width
    (tests/test_bootstrap_refscale.py).  Returns the kernel numbers at this
    ring's shapes, the launches of the gated call, and the context's
    objects for the serialize phase."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch import bootstrap as bs
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.ring import sample as smp
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf
    from gpqhe_tpu_torch.utils import trace

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = HeContext(logn=15, q=1 << LOGQ[15], slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    eng.ring.ntt_plan(ctx.dim)                   # kernel tables, outside the keygen time
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    kernels = phase_kernels(iters, bootstrap_cases(eng), tag="kernels15")

    mine, other = chain_counters(59)
    t1 = time.time()
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rots = bs.bootstrap_rotations(ctx)
    rk = eng.genrk(sk, rots)
    torch.cuda.synchronize()
    keygen_s = time.time() - t1
    keygen_launches = dict(mine)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots) * 0.1
    bctx = bs.BootstrapContext(eng)
    # the gated run, encrypt -> moddown to l=1 -> bootstrap -> decrypt:
    # counters zeroed just before it and read just after
    mine, other = chain_counters(59)
    ct_top = eng.enc_pk(eng.ecd(m0), pk)
    ct = ct_top
    while ct.l > 1:
        ct = eng.moddown(ct)

    def run():
        return bs.bootstrap(eng, bctx, ct, rlk, ck, rk)      # iter derived from h: 9
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    boot = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t2
    got = eng.dcd(eng.dec(boot, sk))
    launches, foreign = dict(mine), dict(other)
    diff = float(np.max(np.abs(got - m0)))
    ok_shape = (got.shape == (ctx.slots,) and bool(np.all(np.isfinite(got)))
                and tuple(boot.c0.shape) == (ctx.poly.n, eng.kl(boot.l)))

    few = max(1, iters // 5)
    boot_s = wall_s(run, few)
    with StageClock(bs) as clock:
        run()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    with trace.op_trace() as tr:
        run()
    profile_op("bootstrap", run, host_ops=False, warm=False)
    emit({"phase": "bootstrap", "logn": 15, "logq": LOGQ[15], "slots": 4, "logDelta": 30,
          "iter": bs.min_bootstrap_iter(ctx), "L": ctx.L, "kq": eng.kq, "dim": ctx.dim,
          "dim_mul": ctx.dim_mul(ctx.L), "dim_swk": ctx.dim_swk(ctx.L), "dimswk": ctx.dimswk,
          "dimswk_h": eng.dimswk_h, "dimub": ctx.poly.dimub, "rotation_keys": len(rots),
          "setup_s": setup_s, "keygen_s": keygen_s, "keygen_launches": keygen_launches,
          "first_bootstrap_s": first_s, "bootstrap_s": boot_s, "timed_runs": few,
          "stage_s": clock.stages(t_end), "level_in": ct.l, "level_out": boot.l,
          "decode_diff": diff,
          "fallbacks": {name: plan.fallbacks for name, plan in bctx._plans.items()},
          "launches": launches, "other_kernel_launches": foreign,
          "op_trace": {"counts": tr.counts,
                       "seconds": {k: round(v, 4) for k, v in tr.seconds.items()}},
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    if not ok_shape:
        raise AssertionError("bootstrap output has the wrong shape or non-finite slots")
    if not boot.l >= 10:
        raise AssertionError(f"bootstrap came back at level {boot.l} < 10")
    if not diff < 1e-2:
        raise AssertionError(f"bootstrap decode diff {diff} >= 1e-2")
    require_launches("bootstrap", launches, foreign)
    return {"kernels": kernels, "launches": launches,
            "objects": dict(ctx=ctx, eng=eng, sk=sk, rlk=rlk, ck=ck, rk=rk, ct=ct_top, boot=boot)}


def phase_serialize(o: dict) -> None:
    """save / load at the bootstrap context: the bootstrapped ciphertext,
    rlk and the 16-key rotation bank through .npz files and back onto the
    card (load's default device)."""
    import tempfile

    import torch
    from gpqhe_tpu_torch.utils import serialize

    ctx, eng = o["ctx"], o["eng"]
    mine, other = chain_counters(59)
    sizes, secs = {}, {}
    with tempfile.TemporaryDirectory() as d:
        loaded = {}
        for name in ("boot", "rlk", "rk"):
            path = os.path.join(d, name + ".npz")
            t0 = time.perf_counter()
            serialize.save(path, ctx, o[name])
            t1 = time.perf_counter()
            loaded[name] = serialize.load(path, ctx)        # no device given: the card
            torch.cuda.synchronize()
            secs[name] = {"save_s": t1 - t0, "load_s": time.perf_counter() - t1}
            sizes[name] = os.path.getsize(path) / 2**20

    def tensors(x):
        if isinstance(x, dict):
            return [t for r in sorted(x) for t in tensors(x[r])]
        return [v for v in vars(x).values() if isinstance(v, torch.Tensor)]
    equal = {}
    for name in loaded:
        a, b = tensors(o[name]), tensors(loaded[name])
        equal[name] = (len(a) == len(b) > 0 and all(y.is_cuda and torch.equal(x, y)
                                                     for x, y in zip(a, b)))
    meta_ok = (loaded["boot"].l, loaded["boot"].nu, loaded["boot"].B) == \
        (o["boot"].l, o["boot"].nu, o["boot"].B) and sorted(loaded["rk"]) == sorted(o["rk"])
    ct = o["ct"]
    a, b = eng.mul_rs(ct, ct, o["rlk"]), eng.mul_rs(ct, ct, loaded["rlk"])
    r = max(o["rk"])
    c, e = eng.rot(ct, r, o["rk"]), eng.rot(ct, r, loaded["rk"])
    same = all(torch.equal(x, y) for x, y in ((a.c0, b.c0), (a.c1, b.c1), (c.c0, e.c0),
                                              (c.c1, e.c1)))
    torch.cuda.synchronize()
    launches = dict(mine)
    emit({"phase": "serialize", "file_mb": sizes, "seconds": secs, "tensors_equal": equal,
          "ledger_equal": meta_ok, "ops_from_loaded_keys_equal": same, "rotation": r,
          "launches": launches})
    if not (all(equal.values()) and meta_ok):
        raise AssertionError(f"serialize: loaded objects differ: {equal}, ledger {meta_ok}")
    if not same:
        raise AssertionError("serialize: mul_rs / rot from the loaded keys differ")
    if launches["fwd"] <= 0 or launches["inv_scaled"] <= 0 or any(other.values()):
        raise AssertionError(f"serialize: NTT launches {launches}")


def phase_cli() -> None:
    """The per-op CLI as a user runs it, at its defaults, on the card."""
    import re
    for argv in (["mul", "pk"], ["exp"]):
        t0 = time.time()
        out = subprocess.run([sys.executable, "-m", "gpqhe_tpu_torch"] + argv, cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        lines = out.stdout.splitlines()
        oks = [ln for ln in lines if ln.startswith("[ok] ")]
        m = re.search(r"^device (.*): NTT kernel launches (\{.*\})$", out.stdout, re.M)
        counts = json.loads(m.group(2).replace("'", '"')) if m else {}
        emit({"phase": "cli", "argv": argv, "returncode": out.returncode, "ok_lines": oks,
              "device": m.group(1) if m else None, "launches": counts,
              "seconds": time.time() - t0})
        if out.returncode != 0 or not oks or any(ln.startswith("[FAIL]") for ln in lines):
            raise AssertionError(f"cli {argv}: exit {out.returncode}\n{out.stdout[-2000:]}"
                                 f"\n{out.stderr[-2000:]}")
        if not counts or any(c <= 0 for c in counts.values()):
            raise AssertionError(f"cli {argv}: NTT launches {counts}")


# ---------------------------------------------------------------------------
# the suite phase: the rest of the JAX package's test suite, held on the card
# ---------------------------------------------------------------------------

def port_api():
    """The names a suite case calls, from the port.  The CPU tests hand the
    same names from the JAX package to run a case there."""
    from types import SimpleNamespace

    import gpqhe_tpu_torch as gt
    from gpqhe_tpu_torch import bootstrap
    from gpqhe_tpu_torch.algo import linalg
    from gpqhe_tpu_torch.ring import sample
    from gpqhe_tpu_torch.ring.canemb import invcanemb
    return SimpleNamespace(HeContext=gt.HeContext, CKKS=gt.CKKS, Surf=gt.Surf, linalg=linalg,
                           bootstrap=bootstrap, sample=sample, invcanemb=invcanemb)


def oracle_module():
    """tests/torch_oracle.py: the jax-free copy of tests/test_kat.py's exact
    Python-integer oracle."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_oracle
    return torch_oracle


CRT_CHAIN = dict(q=1 << 8, logp=9, dim_cap=6)      # tests/test_crt_mode.py, at logn=4


def crt_chain_ring(device):
    """A ring of tests/test_crt_mode.py's logp=9 debug chain: six primes of
    10-11 bits at n=2^4, below 2^30, so served by the u32 kernel."""
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ring.poly import RingEngine
    return RingEngine(PolyContext(4, **CRT_CHAIN), device=device)


def crt_chain_case(ring, seed: int = 21) -> dict:
    """The logp=9 chain's path on ring (crt_chain_ring): at every dim from
    dimub down to 1, values below P (0, 1 and P-1 among them) as limbs,
    decompose, reconstruct(center=False); and the residues through the
    forward NTT, the plain inverse (back to the residues) and the scaled
    inverse into reconstruct(center=False, pre_scaled=True).  Returns, per
    dim, whether each step gave the exact integers back."""
    import random

    import numpy as np
    import torch
    from gpqhe_tpu_torch.ops import rns
    from gpqhe_tpu_torch.ops.modmath import torch_to_u64
    from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
    from gpqhe_tpu_torch.substrate import bigint

    pctx, rnd, out = ring.pctx, random.Random(seed), {}
    for dim in range(pctx.dimub, 0, -1):
        b = pctx.basis(dim)
        vals = [rnd.randrange(b.P) for _ in range(pctx.n)]
        vals[:3] = [0, 1, b.P - 1]
        k = bigint.nlimbs(b.P.bit_length())
        limbs = torch.from_numpy(bigint.ints_to_limbs(vals, k).astype(np.int64)).to(ring.device)
        res = rns.decompose(limbs, ring.ba(dim), ring.weights(dim, k))
        hat = ring.ntt_f(res, dim)
        back = ring.ntt_i(hat, dim)
        scaled = ring.ntt_i(hat, dim, scale_phatinv=True)
        plain = rns.reconstruct(res, ring.ba(dim), ring.recon(dim), center=False)
        fused = rns.reconstruct(scaled, ring.ba(dim), ring.recon(dim), center=False,
                                pre_scaled=True)
        host = torch_to_u64(res)
        out[dim] = {
            "decompose": all([int(x) for x in host[d]] == [v % p for v in vals]
                             for d, p in enumerate(b.primes)),
            "reconstruct": bigint.limbs_to_ints(limbs_to_numpy(plain)) == vals,
            "ntt_roundtrip": bool(torch.equal(back, res)),
            "ntt_reconstruct": bigint.limbs_to_ints(limbs_to_numpy(fused)) == vals}
    return out


def bsgs_n1(slots: int) -> int:
    """The giant step of algo/linalg.py's GemvPlan: isqrt(slots) when slots is
    a square, else isqrt(2 slots)."""
    import math
    n1 = math.isqrt(slots)
    return n1 if n1 * n1 == slots else math.isqrt(2 * slots)


def gemv_packing_case(logp: int, slots: int, api=None, **engine_kw) -> dict:
    """tests/test_algo.py::test_gemv_hoisted_slots256 with `slots` slots at
    logn=9/logq=120/Delta=2^30 on the logp chain: rotation keys for the baby
    steps and the giant-step multiples only, so the hoisted gemv takes the
    streamed BSGS route (one diagonal slab per giant step); the matrix from
    numpy seed 5, the message from the engine's stream.  slots=256 is full
    packing (gap 1, n1=16, 16 giant steps), slots=8 a count that is not a
    square (n1=4, n2=2)."""
    import numpy as np
    api = api or port_api()
    ctx = api.HeContext(logn=9, q=1 << 120, slots=slots, Delta=1 << 30, logp=logp)
    eng = api.CKKS(ctx, rng=api.Surf(), **engine_kw)
    pk, sk = eng.keypair()
    n1 = bsgs_n1(slots)
    rk = eng.genrk(sk, rotations=sorted(set(range(n1)) | {i * n1 for i in range(slots // n1)}))
    rng = np.random.default_rng(5)
    A = (rng.standard_normal(slots * slots) + 1j * rng.standard_normal(slots * slots)) * 0.1
    m = api.sample.sample_z01vec(eng.rng, slots)
    ct = eng.enc_pk(eng.ecd(m), pk)
    plan = api.linalg.HoistedGemvPlan(eng, A)
    out = api.linalg.gemv(eng, None, ct, rk, plan=plan, hoisted=True)
    got = eng.dcd(eng.dec(out, sk))
    return {"out": out, "rk": rk, "n1": plan.n1, "n2": plan.n2, "fallbacks": plan.fallbacks,
            "diff": float(np.max(np.abs(got - A.reshape(slots, slots) @ m)))}


def c2s_packing_case(logp: int, api=None, **engine_kw) -> dict:
    """tests/test_bootstrap.py::test_full_packing_c2s at logn=5/q=2^400/
    slots=16 (= n/2, gap 1) on the logp chain: U0 and U1 against the
    reference's DFT construction (u_diff), and coeff2slot of an encryption
    of a message from the engine's stream, whose two outputs decode to the
    real and imaginary encode coefficients (diffs)."""
    import numpy as np
    api = api or port_api()
    slots = 16
    ctx = api.HeContext(logn=5, q=1 << 400, slots=slots, Delta=1 << 30, logp=logp)
    eng = api.CKKS(ctx, rng=api.Surf(), **engine_kw)
    bs = api.bootstrap
    bctx = bs.BootstrapContext(eng)
    poly = ctx.poly
    nh = poly.n // 2
    gap = nh // slots
    zeta = np.exp(2j * np.pi * np.array([int(poly.cyc_group[i * gap]) for i in range(slots)])
                  / poly.m)
    j = np.arange(slots)
    U0 = zeta[:, None] ** (j * gap)[None, :]
    U1 = zeta[:, None] ** (j * gap + nh)[None, :]
    u_diff = max(float(np.max(np.abs(np.asarray(bctx.U0).reshape(slots, slots) - U0))),
                 float(np.max(np.abs(np.asarray(bctx.U1).reshape(slots, slots) - U1))))
    pk, sk = eng.keypair()
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m0 = api.sample.sample_z01vec(eng.rng, slots)
    pt = eng.ecd(m0)
    u = api.invcanemb(m0, slots, poly.cyc_group, poly.ring_zetas, poly.m)
    want = (np.round(u.real * ctx.Delta) / ctx.Delta, np.round(u.imag * ctx.Delta) / ctx.Delta)
    ct0, ct1 = bs.coeff2slot(eng, bctx, eng.enc_pk(pt, pk), ck, rk)
    diffs = [float(np.max(np.abs(eng.dcd(eng.dec(c, sk)) - w))) for c, w in zip((ct0, ct1), want)]
    return {"ct0": ct0, "ct1": ct1, "rk": rk, "u_diff": u_diff, "diffs": diffs,
            "fallbacks": {name: plan.fallbacks for name, plan in bctx._plans.items()}}


def full_width_checks(eng, pk, sk, rlk, ck, rk) -> dict:
    """tests/test_full_params.py's checks with tests/test_scheme.py's add and
    mul variants and test_rot_all, on an engine and its keys (rk: every slot
    rotation): enc_sk and enc_pk round trips, moddown, add, sub, addpt,
    subpt, neg, rs(mul), rs(mulpt), a chained rs(mul) one level down, conj,
    and rot by every r in 0..slots-1.  Messages from the engine's stream.
    Returns the decode diff of each against its plaintext result, and
    whether rs(mul) came out one level down."""
    import numpy as np
    from gpqhe_tpu_torch.ring import sample as smp
    slots = eng.ctx.slots
    m0, m1, m2 = (smp.sample_z01vec(eng.rng, slots) for _ in range(3))

    def dcd(ct):
        return eng.dcd(eng.dec(ct, sk))
    pt = eng.ecd(m0)
    ct0 = eng.enc_pk(pt, pk)
    ct1, ct2 = eng.enc_pk(eng.ecd(m1), pk), eng.enc_pk(eng.ecd(m2), pk)
    pt2 = eng.ecd(m2)
    ctm = eng.rs(eng.mul(ct1, ct2, rlk))
    got = {"enc_sk": (eng.enc_sk(pt, sk), m0), "enc_pk": (ct0, m0),
           "moddown": (eng.moddown(ct0), m0),
           "add": (eng.add(ct1, ct2), m1 + m2), "sub": (eng.sub(ct1, ct2), m1 - m2),
           "addpt": (eng.addpt(ct1, pt2), m1 + m2), "subpt": (eng.subpt(ct1, pt2), m1 - m2),
           "neg": (eng.neg(ct1.copy()), -m1), "mul": (ctm, m1 * m2),
           "mulpt": (eng.rs(eng.mulpt(ct1, eng.ecd(m2))), m1 * m2),
           "mul_chain": (eng.rs(eng.mul(ctm, eng.moddown(eng.enc_pk(eng.ecd(m1), pk)), rlk)),
                         m1 * m2 * m1),
           "conj": (eng.conj(ct0.copy(), ck), np.conj(m0))}
    for r in range(slots):
        got[f"rot{r}"] = (eng.rot(ct0.copy(), r, rk), np.roll(m0, -r))
    diffs = {name: float(np.max(np.abs(dcd(ct) - want))) for name, (ct, want) in got.items()}
    return {"diffs": diffs, "mul_level_ok": ctm.l == ct1.l - 1}


def equal_cts(a, b) -> dict:
    """Per half, the first index at which two ciphertexts differ (None where
    torch.equal), with their ledgers."""
    return {"c0": first_difference(a.c0, b.c0), "c1": first_difference(a.c1, b.c1),
            "ledger": None if (a.l, a.nu, a.B) == (b.l, b.nu, b.B) else
            [[a.l, a.nu, a.B], [b.l, b.nu, b.B]]}


def phase_suite(iters: int, linalg59: dict | None) -> dict:
    """The rest of the JAX package's test suite on the card (tests/
    test_kat.py, test_crt_mode.py, test_algo.py's full packing,
    test_bootstrap.py's full-packing coeff2slot, test_full_params.py), each
    gate raising.  linalg59: the linalg59 phase's engine and keys at
    logn=14/logq=438/slots=16/Delta=2^50, or None to make them here.
    Returns the logp=9 chain's kernel rows and their launches."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.ops import ntt_cuda32

    api = port_api()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    t0 = time.time()
    problems = []

    # the logp=9 chain: the u32 kernel on 10-11-bit primes at n=2^4.  Its
    # path, counters zeroed just before and read just after
    ring = crt_chain_ring(cuda)
    if ring.ntt_mod is not ntt_cuda32:
        raise AssertionError("the logp=9 chain does not select the u32 kernel")
    mine, other = chain_counters(9)
    crt = crt_chain_case(ring)
    torch.cuda.synchronize()
    launches, foreign = dict(mine), dict(other)
    emit({"phase": "suite", "case": "crt_logp9", "primes": ring.pctx.primes, "n": ring.pctx.n,
          "per_dim": crt, "launches": launches, "other_kernel_launches": foreign})
    if not all(all(v.values()) for v in crt.values()):
        problems.append(f"logp=9 chain: {crt}")
    require_launches("suite crt_logp9", mine, other)
    rng = np.random.default_rng(9)
    kernels = {}
    for mode in MODES:
        r = compare_plan("ntt32p9", ring.ntt_mod, ring.ntt_plan(3), mode, (3, ring.pctx.n),
                         iters, rng, tag="suite_kernels")
        kernels[f"ntt32p9_{mode}"] = {k: r[k] for k in ("max_abs_err", "ms", "host_us",
                                                        "plain_ms", "bound_ms", "bound_by",
                                                        "shape")}

    # the exact oracle, both chains: every ciphertext limb for limb
    orc = oracle_module()
    for logp in (59, 29):
        for name, ring_kw, seq in (("kat", orc.KAT_RING, orc.kat_sequence),
                                   ("ladder", orc.LADDER_RING, orc.ladder_sweep)):
            ctx = api.HeContext(**ring_kw, logp=logp)
            eng = api.CKKS(ctx, rng=api.Surf(), device=cuda)
            mine, other = chain_counters(logp)
            t1 = time.time()
            res = seq(eng, orc.Oracle(ctx))
            bad = {n: orc.first_mismatch(eng, c, o) for n, c, o in res}
            bad = {n: v for n, v in bad.items() if v}
            emit({"phase": "suite", "case": f"oracle_{name}", "logp": logp,
                  "logn": ring_kw["logn"], "logq": ring_kw["q"].bit_length() - 1,
                  "L": ctx.L, "ciphertexts": len(res), "mismatches": bad,
                  "launches": dict(mine), "seconds": time.time() - t1})
            if bad:
                problems.append(f"oracle {name} logp={logp}: {bad}")
            require_launches(f"suite oracle {name} logp={logp}", mine, other)

    # full packing and a non-square slot count: the card against the CPU port
    for logp in (59, 29):
        for slots in (256, 8):
            t1 = time.time()
            c = gemv_packing_case(logp, slots, device=cuda)
            h = gemv_packing_case(logp, slots, device=cpu)
            differ = equal_cts(c["out"], h["out"])
            emit({"phase": "suite", "case": "gemv", "logp": logp, "slots": slots, "n1": c["n1"],
                  "n2": c["n2"], "decode_diff": c["diff"], "fallbacks": c["fallbacks"],
                  "first_difference_from_cpu": differ, "seconds": time.time() - t1})
            if not (c["diff"] < 1e-5 and c["fallbacks"] == 0 and not any(differ.values())):
                problems.append(f"gemv logp={logp} slots={slots}: {c['diff']} "
                                f"{c['fallbacks']} {differ}")
        t1 = time.time()
        c, h = c2s_packing_case(logp, device=cuda), c2s_packing_case(logp, device=cpu)
        differ = {k: equal_cts(c[k], h[k]) for k in ("ct0", "ct1")}
        emit({"phase": "suite", "case": "c2s_full_packing", "logp": logp, "u_diff": c["u_diff"],
              "decode_diffs": c["diffs"], "fallbacks": c["fallbacks"],
              "first_difference_from_cpu": differ, "seconds": time.time() - t1})
        if not (c["u_diff"] < 1e-9 and max(c["diffs"]) < 1e-5
                and not any(any(d.values()) for d in differ.values())):
            problems.append(f"c2s logp={logp}: {c['u_diff']} {c['diffs']} {differ}")

    # tests/test_full_params.py at full width, on the linalg59 phase's keys
    t1 = time.time()
    if linalg59 is None:
        ctx = api.HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50)
        eng = api.CKKS(ctx, rng=api.Surf(), device=cuda)
        pk, sk = eng.keypair()
        keys = (eng, pk, sk, eng.genrlk(sk), eng.genck(sk), eng.genrk(sk))
        made = "here"
    else:
        keys, made = linalg59["keys"], "linalg59 phase"
    eng = keys[0]
    mine, other = chain_counters(59)
    full = full_width_checks(*keys)
    torch.cuda.synchronize()
    ctx = eng.ctx
    emit({"phase": "suite", "case": "full_params", "logn": ctx.poly.n.bit_length() - 1,
          "logq": ctx.poly.logq, "slots": ctx.slots, "logDelta": int(ctx.Delta).bit_length() - 1,
          "keys_from": made, "rotations": sorted(keys[5]),
          "decode_diffs": full["diffs"], "mul_level_ok": full["mul_level_ok"],
          "launches": dict(mine), "seconds": time.time() - t1})
    bad = {k: d for k, d in full["diffs"].items() if not d < 1e-5}
    if bad or not full["mul_level_ok"] or any(f"rot{r}" not in full["diffs"] for r in range(16)):
        problems.append(f"full width: {bad}, mul level {full['mul_level_ok']}")
    require_launches("suite full_params", mine, other)
    emit({"phase": "suite", "seconds": time.time() - t0, "problems": problems})
    if problems:
        raise AssertionError(f"suite: {problems}")
    return {"kernels": kernels, "launches": {f"ntt32p9_{k}": v for k, v in launches.items()}}


PHASES = ("build", "kernels", "golden", "mul_rs", "linalg59", "linalg29", "suite", "mesh",
          "mesh_mp", "nonlinear", "cmp", "bootstrap", "serialize", "cli")


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
    if "serialize" in phases and "bootstrap" not in phases:
        ap.error("the serialize phase runs on the bootstrap phase's objects: add bootstrap")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.time()

    def clock(after: str) -> None:
        emit({"phase": "clock", "after": after, "elapsed_s": round(time.time() - t_start, 1)})

    kernels, launches = {}, {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernels = phase_kernels(args.iters)
        clock("kernels")
    if "golden" in phases:
        phase_golden()
    if "mul_rs" in phases:
        phase_mul_rs(max(3, args.iters // 4))
        clock("mul_rs")
    chains = {}
    for name, logp, kernel in (("linalg59", 59, "ntt"), ("linalg29", 29, "ntt32")):
        if name in phases:
            r = chains[logp] = phase_linalg(name, logp, args.iters, chains.get(59))
            launches.update({f"{kernel}_{k}": v for k, v in r["launches"].items()})
            for key, err in r["errs"].items():
                if key in kernels:
                    kernels[key]["max_abs_err"] = max(kernels[key]["max_abs_err"], err)
    if len(chains) == 2:
        # does the 30-bit chain pay?  one mul_rs on each chain, in turns
        order = (59, 29, 29, 59)
        emit({"phase": "chains", "order": list(order),
              "mul_rs_ms": [cuda_ms(chains[logp]["mul_rs"], args.iters) for logp in order]})
    clock("linalg")
    if "suite" in phases:
        r = phase_suite(args.iters, chains.get(59))
        kernels.update(r["kernels"])
        launches.update(r["launches"])
        clock("suite")
    chains = None

    if "mesh" in phases:
        r = phase_mesh(args.iters)
        kernels.update(r["kernels"])
        launches.update(r["launches"])
        clock("mesh")
    if "mesh_mp" in phases:
        phase_mesh_mp(max(3, args.iters // 4))
        clock("mesh_mp")
    if "nonlinear" in phases:
        phase_nonlinear(args.iters)
        clock("nonlinear")
    if "cmp" in phases:
        phase_cmp(args.iters)
        clock("cmp")
    if "bootstrap" in phases:
        boot = phase_bootstrap(args.iters)
        kernels.update(boot["kernels"])
        launches.update({f"ntt15_{k}": v for k, v in boot["launches"].items()})
        if "serialize" in phases:
            phase_serialize(boot["objects"])
        clock("bootstrap and serialize")
    if "mesh" in phases:
        # the mesh phase's composition, on the bootstrap phase's keys
        r = phase_mesh_compose(args.iters, boot["objects"] if "bootstrap" in phases else None)
        kernels.update(r["kernels"])
        launches.update(r["launches"])
        clock("mesh_compose")
    boot = None
    if "cli" in phases:
        phase_cli()
    clock("all phases")

    print(gpu_line(), flush=True)
    if set(phases) != set(PHASES):
        emit({"ok": True, "partial": phases, "kernels": kernels, "launches": launches})
        return 0
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name.split("_")[0]]["source"],
         "replaces": KERNELS[name.split("_")[0]]["replaces"],
         "launches": launches[name], "library_ms": None, **v}
        for name, v in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
