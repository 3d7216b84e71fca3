#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpqhe_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero:
  1. build   — compile csrc/ntt.cu with nvcc (sm_90a) and load it; the
               card's name and power limit from nvidia-smi.
  2. kernels — the CUDA NTT against its plain torch twin on the card,
               torch.equal on random residues at the main path's shapes,
               with both median times (CUDA events, after warm-up).
  3. golden  — the logn=11 replay of tests/golden/golden_logn11.json
               (enc, add, mul+rs, moddown) within tests/test_golden.py's
               tolerances.
  4. mul_rs  — the main path at logn=14/logq=438/slots=16/Delta=2^50 from
               Surf(): keypair, genrlk, ecd + enc_pk x2, mul_rs, dec, dcd;
               decode diff vs m1*m2 < 1e-5; every NTT launch counter > 0;
               keygen seconds and the mul_rs median; before it, a
               `profile` line: one mul_rs under torch.profiler.
Then: the nvidia-smi line, the per-kernel JSON line, and last
{"ok": true, "device": {...}}.

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

SHAPES_FWD = [(4, 16, 1 << 14), (24, 1 << 14), (8, 1 << 14), (8, 16, 1 << 16),
              (2, 3, 1 << 4)]
SHAPES_INV_SCALED = [(3, 16, 1 << 14), (2, 24, 1 << 14)]
SHAPES_INV = [(8, 1 << 14), (8, 16, 1 << 16), (2, 3, 1 << 4)]
ITERS = 20      # timed runs per median
# the shape at which each entry's time is reported (its main-path call)
MAIN_SHAPE = {"fwd": (4, 16, 1 << 14), "inv_scaled": (3, 16, 1 << 14),
              "inv": (8, 1 << 14)}


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


def phase_build():
    from gpqhe_tpu_torch.ops import ntt_cuda
    t0 = time.time()
    ntt_cuda.load_library()
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in ntt_cuda.BUILD_LOG.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": secs, "gpu": gpu_line(), "ptxas": ptxas})


def _ring(logn: int, dim: int):
    """A PolyContext with >= dim primes of the default 59-bit chain."""
    from gpqhe_tpu_torch.context import PolyContext
    if logn == 14:  # the main path's ring: logq=438 gives dimub=30 primes
        return PolyContext(14, 1 << 438)
    return PolyContext(logn, 1 << (59 * dim), dim_cap=dim)


def phase_kernels(iters: int) -> dict:
    import numpy as np
    import torch
    from gpqhe_tpu_torch.ops import ntt as twin
    from gpqhe_tpu_torch.ops import ntt_cuda
    from gpqhe_tpu_torch.ring.poly import RingEngine

    dev = torch.device("cuda")
    engines = {}
    result = {k: {"max_abs_err": 0, "ms": None, "plain_ms": None} for k in MAIN_SHAPE}
    rng = np.random.default_rng(2024)
    cases = ([("fwd", s) for s in SHAPES_FWD]
             + [("inv_scaled", s) for s in SHAPES_INV_SCALED]
             + [("inv", s) for s in SHAPES_INV])
    for mode, shape in cases:
        n, dim = shape[-1], shape[-2]
        logn = n.bit_length() - 1
        key = (logn, dim if logn != 14 else 30)
        if key not in engines:
            engines[key] = RingEngine(_ring(logn, key[1]), device=dev)
        ring = engines[key]
        plan = ring.ntt_plan(dim)
        ba = plan.ba
        ps = np.array(ring.pctx.primes[:dim], dtype=np.uint64)
        host = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64)
                % ps[:, None]).astype(np.int64)
        a = torch.from_numpy(host).to(dev)
        if mode == "fwd":
            def kern():
                return ntt_cuda.ntt(a, plan)

            def plain():
                return twin.ntt(a, ba.zetas, ba.ps, ba.pinv)
        else:
            scale = ba.ninvphat_mont if mode == "inv_scaled" else ba.ninv_mont

            def kern():
                return ntt_cuda.intt(a, plan, scaled=mode == "inv_scaled")

            def plain():
                return twin.intt(a, ba.zetas_inv, ba.ps, ba.pinv, scale)
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = int((got - want).abs().max().item())
        ms = cuda_ms(kern, iters)
        plain_ms = cuda_ms(plain, max(3, iters // 4))
        emit({"phase": "kernels", "entry": mode, "shape": list(shape),
              "equal": equal, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        if not equal:
            raise AssertionError(f"CUDA NTT {mode} {shape} differs from its twin")
        r = result[mode]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if shape == MAIN_SHAPE[mode]:
            r["ms"], r["plain_ms"] = ms, plain_ms
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
    eng.genck(sk)                      # keeps the surf stream in step
    eng.genrk(sk)
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
        "moddown": (dcd(eng.moddown(ct1)), 1e-9),
    }
    diffs = {}
    for name, (got, tol) in checks.items():
        diffs[name] = float(np.max(np.abs(got - g[name])))
        if not diffs[name] < tol:
            raise AssertionError(f"golden {name}: diff {diffs[name]} (tol {tol})")
    emit({"phase": "golden", "diffs": diffs, "seconds": time.time() - t0})


def profile_mul_rs(fn) -> None:
    """One mul_rs under torch.profiler: device busy time, the NTT kernels'
    share of it, the number of device kernels, and the device idle share of
    the host wall time."""
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
        emit({"phase": "profile", "device_time": "not measured"})
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ntt_us = sum(v for k, v in by_name.items() if "ntt_" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
          "idle_share": 1 - busy_us / wall_us, "device_kernels": len(kernels),
          "ntt_kernels": sum(1 for e in kernels if "ntt_" in e.name),
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
    profile_mul_rs(lambda: eng.mul_rs(ct1, ct2, rlk))
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    kernels = phase_kernels(ITERS)
    phase_golden()
    launches = phase_mul_rs(ITERS)

    print(gpu_line(), flush=True)
    emit({"kernels": [
        {"name": f"ntt_{k}", "route": "cuda", "source": "gpqhe_tpu_torch/csrc/ntt.cu",
         "replaces": "gpqhe_tpu/ops/ntt_pallas.py:303",
         "launches": launches[k], **v} for k, v in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
