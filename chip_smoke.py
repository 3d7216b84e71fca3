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
             logp=29 chain) against the plain torch twin on the card and
             against the first-design kernel kept in the same library
             (entries gpqhe_ntt_v1 / gpqhe_ntt32_v1, called from here only):
             torch.equal of all three on random residues at the paths'
             shapes; the device time per launch of the kernel and of v1, in
             turns (v1, new, new, v1), each a run of many launches between
             one pair of CUDA events with the host enqueueing ahead of the
             device, inputs L2-warm; the wrapper's host time per call; the
             twin's median; the bound.
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
Then: the nvidia-smi line, the per-kernel JSON line (six entries), and last
{"ok": true, "device": {...}}.  --phases a,b,c runs a subset (the last line
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
MODES = ("fwd", "inv", "inv_scaled")
ITERS = 20      # timed runs per median
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


_V1 = {}           # kernel -> bound v1 entry point
_V1_TABLES = {}    # (id of a plan's tables, inverse) -> (z, companions, the tables)


def v1_transform(kernel: str, a, plan, mode: str):
    """One transform through the first-design kernel (one block per slab;
    entries gpqhe_ntt_v1 / gpqhe_ntt32_v1), kept for this comparison and
    bound here: nothing in the package calls it.  It takes the twiddles and
    their companions as two [dim, n] tables, split here from the plan's
    interleaved one."""
    import torch
    from gpqhe_tpu_torch.ops import ntt_cuda, ntt_cuda32
    symbol = "gpqhe_ntt_v1" if kernel == "ntt" else "gpqhe_ntt32_v1"
    if kernel not in _V1:
        mod = ntt_cuda if kernel == "ntt" else ntt_cuda32
        _V1[kernel] = ntt_cuda.bind(mod.SOURCE, symbol, ntables=2)
    inverse = mode != "fwd"
    t = plan.tables
    if (id(t), inverse) not in _V1_TABLES:
        pairs = t.tw_i if inverse else t.tw_f
        _V1_TABLES[id(t), inverse] = (pairs[..., 0].contiguous(),
                                      pairs[..., 1].contiguous(), t)
    z, zs, _ = _V1_TABLES[id(t), inverse]
    logn, nslab = ntt_cuda.check_args(a, plan)
    a = a.contiguous()
    out = torch.empty_like(a)
    sc = plan.scale_phat if mode == "inv_scaled" else plan.scale
    rc = _V1[kernel](a.data_ptr(), out.data_ptr(), nslab, plan.dim, logn, z.data_ptr(),
                     zs.data_ptr(), t.primes.data_ptr(), sc[0].data_ptr(), sc[1].data_ptr(),
                     int(inverse), torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {rc}")
    return out


def pass_breakdown(fn, calls: int = 20) -> dict:
    """Microseconds per call of each device kernel of fn(), by name, from
    torch.profiler over `calls` back-to-back calls: how a transform's time
    splits over its passes, and whether they overlap (their sum against the
    time per launch).  Raises if the profiler shows no NTT kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
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
    if not out:
        raise RuntimeError("the profiler saw no NTT pass kernel: no time per pass")
    return out


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
    (ntt_col_pass<7, false> -> "col L7 fwd"); a first-design kernel by name."""
    import re
    t = (re.search(r"ntt_(col|row)_passILi(\d+)ELb([01])E", name)
         or re.search(r"ntt_(col|row)_pass<(\d+), *(true|false|[01])>", name))
    if t:
        return f"{t.group(1)} L{t.group(2)} {'inv' if t.group(3) in ('1', 'true') else 'fwd'}"
    t = re.search(r"(ntt\d*_(?:smem|stage)_kernel)", name)
    return f"v1 {t.group(1)}" if t else name


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
    >= dim primes (at logn=14: the main path's ring, logq=438)."""
    import torch
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ring.poly import RingEngine
    logp = KERNELS[kernel]["logp"]
    key = (kernel, logn) if logn == 14 else (kernel, logn, dim)
    if key not in _RINGS:
        if logn == 14:
            pctx = PolyContext(14, 1 << 438, logp=logp)
        else:
            pctx = PolyContext(logn, 1 << (logp * dim), logp=logp, dim_cap=dim)
        _RINGS[key] = RingEngine(pctx, device=torch.device("cuda"))
    return _RINGS[key]


def compare_kernel(kernel: str, mode: str, shape, iters: int, rng,
                   breakdown: bool = False) -> dict:
    """One kernel entry against the plain twin and against the first-design
    kernel on random residues on the card: torch.equal of all three, then
    the device time per launch of v1 and of the kernel in turns (v1, new,
    new, v1), the wrapper's host time and the twin's median.  Raises if any
    two differ."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.ops import ntt_cuda

    n, dim = shape[-1], shape[-2]
    ring = kernel_ring(kernel, n.bit_length() - 1, dim)
    plan = ring.ntt_plan(dim)
    ps = np.array(ring.pctx.primes[:dim], dtype=np.uint64)
    host = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64)
            % ps[:, None]).astype(np.int64)
    a = torch.from_numpy(host).to(ring.device)
    scaled = mode == "inv_scaled"
    if mode == "fwd":
        def kern():
            return ring.ntt_mod.ntt(a, plan)

        def plain():
            return ntt_cuda.plain_ntt(a, plan)
    else:
        def kern():
            return ring.ntt_mod.intt(a, plan, scaled=scaled)

        def plain():
            return ntt_cuda.plain_intt(a, plan, scaled)

    def prev():
        return v1_transform(kernel, a, plan, mode)
    got, old, want = kern(), prev(), plain()
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    equal_v1 = bool(torch.equal(got, old))
    err = int((got - want).abs().max().item())
    runs = [device_ms_runs(fn, iters) for fn in (prev, kern, kern, prev)]
    out = {"phase": "kernels", "kernel": kernel, "entry": mode, "shape": list(shape),
           "equal": equal, "equal_v1": equal_v1, "max_abs_err": err,
           "ms": median(runs[1] + runs[2]), "prev_ms": median(runs[0] + runs[3]),
           "turn_ms": [median(r) for r in runs],
           "host_us": host_us(kern), "prev_host_us": host_us(prev),
           "plain_ms": cuda_ms(plain, max(3, iters // 4)),
           **ntt_bound(KERNELS[kernel]["word"], mode, shape)}
    if breakdown:
        out["pass_us"] = pass_breakdown(kern)
    emit(out)
    if not equal:
        raise AssertionError(f"CUDA {kernel} {mode} {shape} differs from its twin")
    if not equal_v1:
        raise AssertionError(f"CUDA {kernel} {mode} {shape} differs from the v1 kernel")
    return out


def phase_kernels(iters: int) -> dict:
    """Every kernel entry against its twin and v1 at CASES; returns, per
    entry name, the numbers of its main-path shape."""
    import numpy as np
    rng = np.random.default_rng(2024)
    result = {}
    for kernel, cases in CASES.items():
        for mode, shape in cases:
            name = f"{kernel}_{mode}"
            main = name not in result          # the first case is the main shape
            r = compare_kernel(kernel, mode, shape, iters if main else max(3, iters // 4), rng,
                               breakdown=main)
            if main:
                result[name] = {k: r[k] for k in ("max_abs_err", "ms", "prev_ms", "host_us",
                                                  "plain_ms", "bound_ms", "bound_by")}
                result[name]["shape"] = list(shape)
            result[name]["max_abs_err"] = max(result[name]["max_abs_err"], r["max_abs_err"])
    emit({"phase": "kernels", "summary": "device ms per launch, new vs v1, main-path shapes",
          "faster_than_v1": {k: v["ms"] < v["prev_ms"] for k, v in result.items()},
          "speedup": {k: v["prev_ms"] / v["ms"] for k, v in result.items()}})
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


def profile_op(op: str, fn, **tags) -> None:
    """One call of fn under torch.profiler: device busy time, the NTT
    kernels' share of it, the number of device kernels, and the device idle
    share of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
            "mul_rs": lambda: eng.mul_rs(ct, ct2, rlk)}


PHASES = ("build", "kernels", "golden", "mul_rs", "linalg59", "linalg29")


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
        print("chip_smoke: no CUDA device; the port's smoke test needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels, launches = {}, {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernels = phase_kernels(args.iters)
    if "golden" in phases:
        phase_golden()
    if "mul_rs" in phases:
        phase_mul_rs(max(3, args.iters // 4))
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
