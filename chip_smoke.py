#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpqhe_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and the script exits
non-zero:
  build    — compile the six CUDA sources (csrc/ntt.cu, ntt32.cu, the
             elementwise kernels modmath.cu, rns.cu, limbs.cu, and the
             four-step NTT's ntt4.cu) with nvcc (sm_90a), one process each,
             started together, and load them;
             the card's name and power limit from nvidia-smi; per kernel
             instantiation ptxas's registers, spills, stack and shared
             memory where this run built the source; for every K7, lift,
             decompose, digit-split, K5 (modmath.cu) and K8 (ntt4.cu)
             instantiation in the libraries as loaded (`row_kernels`),
             cuobjdump's registers, stack, shared and local memory, and a
             raise on any stack frame or local memory; static
             multiply-instruction and tensor-core-product (IMMA, HGMMA)
             counts from cuobjdump, and a raise where a K8 instantiation
             has no tensor-core product.
  kernels  — each CUDA NTT (u64 words on the 59-bit chain, u32 words on the
             logp=29 chain) against the plain torch twin on the card:
             torch.equal on random residues at the paths' shapes; the
             device time per launch in two turns, each a run of many
             launches between one pair of CUDA events with the host
             enqueueing ahead of the device, inputs L2-warm; the wrapper's
             host time per call; the twin's median; the bound.  Then every
             entry of the elementwise kernels (K5 modmath, K4 decompose, K6
             the CRT lift, K7 limbs) torch.equal to its plain torch version
             on edge words at the shapes the paths give it (logn=14 on both
             chains, logn=15; batch 8; the reconstruct end to end at its
             bounds), the first shape of each timed as the NTT is, and for
             select and mask_bits one PyTorch call of the same function
             timed the same way and the ratio (`ms_over_library`); K7 and
             the lift timed at logn=15 too, on `kernels15` lines, and
             decompose, the digit split and every K5 entry at the
             bootstrap's shapes there (retimed15; K5 at the shape classes
             the bootstrap launches most, BOOT15_K5); the rows wider than a
             warp timed at both (`wide`: the exact lift at the key switch's
             basis, geq_const at 62 and 125 limbs); then K7, the lift,
             decompose, the digit split and K5's elementwise entries at the
             edges of their designs (elementwise_edge_cases: 1-3071 limbs,
             whole chunks of 32 limbs and one more, partial blocks, tiles of
             primes, every src_bits edge, rows not a multiple of a thread's
             words, A past 65535, the three prime widths, constant,
             broadcast, strided and misaligned operands), each torch.equal
             to its plain version.
  golden   — the logn=11 replay of tests/golden/golden_logn11.json (enc,
             add, mul+rs, conj, rot1, moddown) within tests/test_golden.py's
             tolerances.
  mul_rs   — encrypt, mul_rs, decrypt at logn=14/logq=438/slots=16/Delta=2^50
             from Surf(): keypair, genrlk, ecd + enc_pk x2, mul_rs, dec, dcd;
             decode diff vs m1*m2 < 1e-5; every u64 launch counter > 0 and
             each elementwise kernel's (the same gate in linalg59/29, mesh
             and bootstrap); keygen seconds and the mul_rs median; with it a
             `profile` line: one mul_rs under torch.profiler, its device
             kernels, busy ms and idle share, split by module (ntt, modmath,
             rns by entry: decompose, digit_split, lift; limbs, matmul (the
             digit matmuls), other torch) and modmath by entry.
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
             (mulpt, rot, mul_rs_batch, both gemv routes), and the kernel
             against its twin at the gemv's shapes.  After both: a `chains` line,
             mul_rs on each chain in turns (59, 29, 29, 59).
  ntt4     — K8, the four-step ("matmul") NTT's stage (csrc/ntt4.cu: one
             launch a stage, u8 digit planes on the tensor cores), against
             its plain version (split, f64 torch.bmm, combine) on the card:
             at the path's shapes on both chains every stage and the whole
             transform torch.equal, and the round trip; each shape timed
             (each stage's device ms, host µs, plain ms, the
             f64 torch.bmm of the plain version's planes alone as
             library_ms, the bound and the shares of its int8-operation and
             byte bounds; the whole transform beside the butterfly kernel's
             at the same shape, with its own bound); at the edges (every
             logn 4-16, batches of 1 and 8, words all 0 or all p - 1, the
             logp=9 chain) and at a stage's largest digit sums (K = 256,
             every byte 255, P8 = 2, 4, 8).  Then the path on
             ntt_impl="matmul", each chain (keypair, genrlk, genck, genrk,
             enc_pk, mul_rs, rot, conj, mulpt, mul_rs_batch(8), the classic
             gemv, gemv_hoisted, dec, dcd): decodes within 1e-5, every
             ciphertext torch.equal to a butterfly engine's from the same
             stream, plan.fallbacks == 1, K8's launches > 0 and K1-K3's 0;
             walls and keygen seconds on both backends, and `profile` lines
             of mul_rs and rot on both (the four-step NTT's stages under
             `by_module` "ntt4").
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
             equal to the local transforms expected.  On a mesh whose
             positions share one device (HeMesh.graphable) every sharded
             program is a CUDA graph: per op whether it is graphed, and
             graph_check against graphs.disabled() on three input sets, each
             also torch.equal to the single-device engine; the launch
             counters and the mesh's traffic of three replays equal to three
             eager calls' (mesh_replays_match).  Walls in turns (eager,
             graphed, graphed, eager) beside the single-device op, a profile
             of each mode (busy ms, device ops, idle share, host dispatches),
             host µs a call both ways, the collectives' transfers and bytes
             per op, peak and reserved memory.  The sharded 3-D poly_mul
             (build_sharded_poly_mul_3d) on the same mesh over the product
             basis: graphed torch.equal to eager and to RingEngine.poly_mul
             on two pairs, its chain's NTT launched, walls in turns.  The copy
             path, each chain at logn=9/logq=120/slots=4/Delta=2^30: the same
             four ops on a (2,2,2) mesh whose position (l, c, b) is on the card
             when l + c is even and on the host otherwise, torch.equal to
             CKKS on the card (the first differing index where not), with
             device-copy bytes > 0 in psum, ppermute, scatter and gather and
             no view in psum or ppermute; its programs eager (graphed: false,
             with the layout's reason).  The CLI
             with --mesh=2x2x1:virtual ([ok]) and without :virtual (exit 2
             where the machine has fewer than 4 GPUs).  After the bootstrap
             phase, on its keys (or on keys of its own when that phase is
             not run): bootstrap.coeff2slot at logn=15/logq=881 on a (2,4,1)
             mesh torch.equal to the single-device result and, graphed, to
             itself under graphs.disabled(), with the same traffic; its
             first call's seconds and memory reserved, walls in turns and a
             profile of each mode (`--phases mesh_compose` runs that part
             without the rest of the phase).
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
             of the same layout (mul_rs).  Every rank's programs eager
             (graphed: false: a graph does not capture the messages).
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
  graphs   — the engine programs as CUDA graphs (utils/graphs.py) against
             the same programs under graphs.disabled() (graph_check): at
             logn=14/logq=438/slots=16/Delta=2^50 on both chains and on
             ntt_impl="matmul", mul_rs, rot, conj, mulpt, mul_rs_batch(8),
             the hoisted gemv fully and BSGS (butterfly only), add, sub, neg,
             rs, moddown, a galois map and dec, each on three fresh input
             sets: torch.equal at the first call and at replays, no result
             overwritten by a later call or sharing memory with another, the
             launch counters of a replay equal to an eager call's.  Per op the
             first call's ms (its captures), walls in turns (eager, graphed,
             graphed, eager), host µs a call both ways, and a profile of
             each (with host_dispatches: graph launches, copies, kernel
             launches; gate: a graphed mul_rs on the 59-bit chain dispatches
             one graph and at most 8 copies).  Then the logn=15 bootstrap on
             the bootstrap phase's keys (its own without that phase), two
             inputs, graphed torch.equal to eager; walls in turns, profiles,
             memory reserved and peaks.
  cli      — `python -m gpqhe_tpu_torch mul pk` and `... exp` as
             subprocesses at their defaults on the card: exit code 0, an
             [ok] line, NTT launches > 0.
Every phase runs the engines as a user does, each program a CUDA graph
replayed per (op, shape) after its first call; `profile` lines taken with
host events carry `host_dispatches`.
Then: the nvidia-smi line, the per-kernel JSON line (K8's stage at the
forward [4, 16, 2^14] with its launches over the ntt4 phase's paths; the
NTT's eighteen entries: the six of the logn=14 path, the u32 kernel's three
on the logp=9 chain, the u64 kernel's three at the bootstrap's logn=15 shapes, and forward
and inverse on per-shard plans for the u64 kernel, the u32 kernel and the u64
kernel on the logn=15 mesh; then each elementwise entry that the gated paths
launched, with its launches summed over them and split by the ring's logn,
`launches_by_logn`: 14 for mul_rs, linalg and mesh, 15 for the bootstrap; K5's
entries also by shape class, `launches_by_shape`),
and last {"ok": true,
"device": {...}}.  --phases a,b,c runs a subset (the last line
then says "partial"); --iters N sets the timed runs per median.

Without a CUDA device, or without the repository beside it, it fails
before printing any result.  Needs no network.
"""

from __future__ import annotations

import contextlib
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


# instantiations of the gated kernels by source: K7's eight chains on rows of
# one chunk and of more, and its word kernel by word and by pair for
# mask_bits and select; the lift on f64 and int64 digit sums at 1, 2 and 4
# chunks, decompose and the digit split; K5's elementwise kernel by op, the
# cross terms, the key products and the sum by mode; K8's stage by byte
# planes (2, 4, 8) and transpose
ROW_KERNELS = {"limbs.cu": 20, "rns.cu": 8, "modmath.cu": 9, "ntt4.cu": 6}


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
}
# 32-bit multiply instructions per u64 Montgomery product: the 64x64 high
# product (4) and the low product (3) of a * b, the low product u = lo * pinv
# (3) and the high product of u * p (4); a mulmod is two of them
IMAD_MONT = 14
# the elementwise kernel's mulmod: one Barrett reduction a word (the 128-bit
# product a b, 7; the high product of x mu, 4; the low product q p, 3)
IMAD_BARRETT = 14
EW_BATCH = 8       # mul_rs_batch's B
EW_N1 = 4          # baby steps of a hoisted gemv step (slots=16 BSGS; slots=4 fully hoisted)
# K5's shape classes that the bootstrap (logn=15) launches most, timed on the
# kernels15 lines: (entry, dim, leading axes, multipliers of a sum); the
# bootstrap phase counts its launches by shape class (modmath_cuda.SHAPES)
# and fails where one of these is no longer among them
BOOT15_K5 = (("modmath_cross_terms", 26, (4,), 0), ("modmath_key_products", 47, (), 0),
             ("modmath_key_products", 44, (), 0), ("modmath_mulmod_sum", 47, (EW_N1,), 2),
             ("modmath_mulmod_sum", 16, (EW_N1,), 0), ("modmath_mulmod", 14, (), 0),
             ("modmath_mulmod", 16, (), 0))


def decompose_imad(out_words: int, k: int, pmax: int) -> int:
    """32-bit multiplies of rns.cu's decompose: per output word, for each
    limb the low and high 32-bit products of the limb and each 32-bit half
    of its constant (two halves for primes past 32 bits, else one), and one
    Montgomery reduction (u = lo * pinv, 3, and the high product of u * p,
    4).  (The earlier design did (k + 1) // 2 Montgomery products of
    IMAD_MONT: the case's imad_mont.)"""
    halves = 2 if pmax >> 32 else 1
    return out_words * (2 * halves * k + 7)


def ew_counters() -> dict:
    """{entry: its launch count} over the three elementwise libraries, and
    K5's launches by shape class, "modmath_<entry> [shape]" (the launch's
    broadcast shape; " xW" after a sum against W multipliers)."""
    from gpqhe_tpu_torch.ops import limbs_cuda, modmath_cuda, rns_cuda
    out = {f"modmath_{k}": v for k, v in modmath_cuda.LAUNCHES.items()}
    for (e, shape, nw), v in getattr(modmath_cuda, "SHAPES", {}).items():
        out[f"modmath_{e} {list(shape)}" + (f" x{nw}" if nw else "")] = v
    out.update({"decompose": rns_cuda.LAUNCHES["decompose"],
                "crt_digit_split": rns_cuda.LAUNCHES["digit_split"],
                "crt_lift": rns_cuda.LAUNCHES["lift"]})
    out.update({f"limbs_{k}": v for k, v in limbs_cuda.LAUNCHES.items()})
    return out


def ew_reset() -> None:
    """Zero the elementwise launch counters and the count of operands the
    wrappers copied (an operand whose strides have no [M, A, rows, cols]
    form; read with ew_copies)."""
    from gpqhe_tpu_torch.ops import cuda_build, limbs_cuda, modmath_cuda, rns_cuda
    for m in (limbs_cuda, modmath_cuda, rns_cuda):
        m.reset_launches()
    cuda_build.COPIES["operands"] = 0


def ew_copies() -> int:
    from gpqhe_tpu_torch.ops import cuda_build
    return cuda_build.COPIES["operands"]


def ew_by_kernel(counts: dict) -> dict:
    """Launches per kernel (K4-K7) from per-entry counts (the counts by
    shape class left out)."""
    out = {k: 0 for k in EW_KERNELS}
    for name, v in counts.items():
        if " " not in name:
            out[name.split("_")[0]] += v
    return out


def require_ew_launches(name: str, counts: dict) -> None:
    """Raise unless each of K4-K7 launched on the path just run."""
    idle = [k for k, v in ew_by_kernel(counts).items() if v <= 0]
    if idle:
        raise AssertionError(f"{name}: the path never launched the elementwise kernels {idle}")


def ew_residues(rng, ps, shape, device):
    """int64 words < p of the prime axis (-2) of shape, the edge words 0, 1
    and p - 1 at the first coefficients of every row."""
    import numpy as np
    import torch
    p = np.asarray(ps, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) % p
    w = min(3, shape[-1])
    x[..., :w] = np.concatenate([np.zeros_like(p), np.ones_like(p), p - 1], axis=1)[:, :w]
    return torch.from_numpy(x.view(np.int64)).to(device)


def ew_words(rng, shape, device, bits: int = 64):
    """Random words of `bits` bits (int64 bit patterns), the edge words 0,
    2^(bits-1) and 2^bits - 1 first along the last axis."""
    import numpy as np
    import torch
    x = rng.integers(0, (1 << bits) - 1, size=shape, dtype=np.uint64, endpoint=True)
    w = min(3, shape[-1])
    x[..., :w] = np.array([0, 1 << (bits - 1), (1 << bits) - 1], dtype=np.uint64)[:w]
    return torch.from_numpy(x.view(np.int64)).to(device)


def ew_limbs(rng, shape, device):
    """u32 limbs [..., rows, K] with edge rows: all 0xFFFFFFFF (a carry
    through every limb), all 0, and 0xFFFFFFFF below a zero top limb."""
    import torch
    x = ew_words(rng, shape, device, bits=32)
    x[..., 0, :] = 0xFFFFFFFF
    x[..., 1, :] = 0
    x[..., 2, :] = 0xFFFFFFFF
    x[..., 2, -1] = 0
    return x


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def geq_read_bytes(a, c) -> int:
    """The bytes geq_const(a, c) must read on these inputs: c once, and of
    each row of a its limbs from the top down to the highest one that
    differs from c's (all of them where the row equals c), the rest
    deciding nothing."""
    import torch
    k = a.shape[-1]
    ne = (a != c).reshape(-1, k)
    top = k - 1 - ne.flip(-1).int().argmax(-1)           # the highest limb that differs
    words = torch.where(ne.any(-1), k - top, torch.full_like(top, k))
    return 8 * (int(words.sum()) + k)


def elementwise_cases(logn: int, logp: int, device, seed: int = 8) -> dict:
    """{entry: [case, ...]}: each case a dict with shape, kern (the public
    dispatcher, which on a CUDA tensor launches the kernel), plain (the
    plain torch version on the same tensors), bytes (each input read once,
    each output written once) and imad (32-bit multiplies) for the bound,
    and library where one PyTorch call computes the same function.
    The shapes are those the paths give the entries at the ring of logn
    (logq 438 or 881) on the logp chain: the product's dim_mul basis, the
    key switch's dim_swk basis against the key bank's dimswk_h rows, batch
    EW_BATCH, a hoisted gemv step of EW_N1 baby steps, the plaintext
    product's basis, the ciphertext's limbs, and at logn=15 K5 at the
    bootstrap's shape classes (BOOT15_K5, marked boot15); the first case of
    an entry is its main-path shape."""
    import dataclasses

    import numpy as np
    import torch
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.ops import limbs as lb
    from gpqhe_tpu_torch.ops import modmath as mm
    from gpqhe_tpu_torch.ops import rns
    from gpqhe_tpu_torch.scheme.engine import CKKS

    rng = np.random.default_rng(seed)
    slots, delta = (16, 1 << 50) if logn == 14 else (4, 1 << 30)
    ctx = HeContext(logn=logn, q=1 << LOGQ[logn], slots=slots, Delta=delta, logp=logp)
    eng = CKKS(ctx, device=device)
    ring = eng.ring
    n, L = ctx.poly.n, ctx.L
    dim_m, dim_s, dh = ctx.dim_mul(L), ctx.dim_swk(L), eng.dimswk_h
    klv, B, n1 = eng.kl(L), EW_BATCH, EW_N1
    cases = {}

    def consts(dim):
        ba = ring.ba(dim)
        return ba.ps[:, None], ba.pinv[:, None], ring.r2(dim)

    def res(dim, lead=()):
        return ew_residues(rng, ring.pctx.primes[:dim], lead + (dim, n), device)

    def add(entry, shape, kern, plain, inputs, out_words, imad, read_bytes=None, **kw):
        cases.setdefault(entry, []).append(dict(
            shape=list(shape), kern=kern, plain=plain, imad=imad,
            bytes=(nbytes(*inputs) if read_bytes is None else read_bytes) + 8 * out_words, **kw))

    # K5 modmath
    bank = [res(dh), res(dh)]

    def cross_case(dim, lead, **kw):
        # lead: (4, ...), the stacked (x0, x1, y0, y1)
        x, c = res(dim, lead), consts(dim)
        add("modmath_cross_terms", x.shape, lambda x=x, c=c: mm.cross_terms(x, *c),
            lambda x=x, c=c: mm.plain_cross_terms(x, *c), [x], 3 * x[0].numel(),
            4 * 2 * IMAD_MONT * x[0].numel(), **kw)

    def keyprod_case(dim, lead, **kw):
        # the key halves: row slices [:dim] of the bank's dimswk_h rows
        d, c, e0, e1 = res(dim, lead), consts(dim), bank[0][:dim], bank[1][:dim]
        add("modmath_key_products", d.shape,
            lambda d=d, e0=e0, e1=e1, c=c: mm.key_products(d, e0, e1, *c),
            lambda d=d, e0=e0, e1=e1, c=c: mm.plain_key_products(d, e0, e1, *c), [d, e0, e1],
            2 * d.numel(), 2 * 2 * IMAD_MONT * d.numel(), **kw)

    def sum_case(dim, lead, nw, **kw):
        # a hoisted step: c1p ptx against the rotation keys' [:, :dim] slices
        x, y, c = res(dim, lead), res(dim, lead), consts(dim)
        ws = [res(dh, lead)[:, :dim] for _ in range(nw)]
        add("modmath_mulmod_sum", x.shape,
            lambda x=x, y=y, c=c, ws=ws: mm.mulmod_sum(x, y, *c, ws=ws),
            lambda x=x, y=y, c=c, ws=ws: mm.plain_mulmod_sum(x, y, *c, ws=ws), [x, y, *ws],
            max(nw, 1) * dim * n, (1 + nw) * 2 * IMAD_MONT * x.numel(), **kw)

    def mulmod_case(dim, lead, **kw):
        x, y, c = res(dim, lead), res(dim, lead), consts(dim)
        add("modmath_mulmod", x.shape, lambda x=x, y=y, c=c: mm.mulmod(x, y, *c),
            lambda x=x, y=y, c=c: mm.plain_mulmod(x, y, *c), [x, y], x.numel(),
            IMAD_BARRETT * x.numel(), imad_mont=2 * IMAD_MONT * x.numel(), **kw)

    cm, cs = consts(dim_m), consts(dim_s)
    for lead in ((4,), (4, B)):
        cross_case(dim_m, lead)
    for lead in ((), (B,)):
        keyprod_case(dim_s, lead)
    sum_case(dim_s, (n1,), 2)
    sum_case(dim_m, (n1,), 0)
    c1p = res(dim_s, (n1,))
    # mulmod on the product's basis, batched, and on a plaintext product's
    # (mulpt's dim_mulpt at a plaintext of the scale Delta)
    dim_pt = ctx.dim_mulpt(L, float(delta))
    for dim, lead in ((dim_m, ()), (dim_m, (B,)), (dim_pt, ())):
        mulmod_case(dim, lead)
    w, v = ew_words(rng, (dim_s, n), device), res(dim_s)
    add("modmath_mont_mul", w.shape, lambda: mm.mont_mul(w, v, *cs[:2]),
        lambda: mm.plain_mont_mul(w, v, *cs[:2]), [w, v], w.numel(), IMAD_MONT * w.numel())
    u, z = res(dim_m), res(dim_m)
    add("modmath_to_mont", u.shape, lambda: mm.to_mont(u, *cm), lambda: mm.plain_to_mont(u, *cm),
        [u], u.numel(), IMAD_MONT * u.numel())
    add("modmath_addmod", u.shape, lambda: mm.addmod(u, z, cm[0]),
        lambda: mm.plain_addmod(u, z, cm[0]), [u, z], u.numel(), 0)
    add("modmath_submod", u.shape, lambda: mm.submod(u, z, cm[0]),
        lambda: mm.plain_submod(u, z, cm[0]), [u, z], u.numel(), 0)
    add("modmath_summod", c1p.shape, lambda: mm.summod(c1p, cs[0]),
        lambda: mm.plain_summod(c1p, cs[0]), [c1p], dim_s * n, 0)
    if logn == 15:
        make = {"modmath_cross_terms": cross_case, "modmath_key_products": keyprod_case,
                "modmath_mulmod": mulmod_case}
        for entry, dim, lead, nw in BOOT15_K5:
            if entry == "modmath_mulmod_sum":
                sum_case(dim, lead, nw, boot15=True)
            else:
                make[entry](dim, lead, boot15=True)

    # K4 decompose
    for dim, lead, src in ((dim_m, (), None), (dim_s, (), None), (dim_m, (B,), None),
                           (dim_m, (), 32 * klv), (dim_s, (), 32 * klv - 5)):
        a = ew_limbs(rng, lead + (n, klv), device)
        ba, wts = ring.ba(dim), ring.weights(dim, klv)
        plain = ((lambda a=a, ba=ba, wts=wts: rns.plain_decompose_core(a, ba.ps, ba.pinv, wts))
                 if src is None else
                 (lambda a=a, ba=ba, wts=wts, src=src:
                  rns.plain_decompose_signed(a, ba.ps, ba.pinv, wts, src)))
        out_words = a.numel() // klv * dim
        add("decompose", a.shape,
            lambda a=a, ba=ba, wts=wts, src=src: rns.decompose(a, ba, wts, src_bits=src), plain,
            [a, wts], out_words, decompose_imad(out_words, klv, max(ring.pctx.primes[:dim])),
            imad_mont=IMAD_MONT * out_words * ((klv + 1) // 2), signed_bits=src, dim=dim)

    # K6 the CRT lift: digit_split and lift on their own inputs, and the
    # whole reconstruct (split, matmul, lift) on values that meet its bounds
    for dim, lead, scaled in ((dim_m, (), False), (dim_m, (3,), False), (dim_s, (), True)):
        ba, plan = ring.ba(dim), ring.recon(dim)
        y = res(dim, lead)
        scale = (ba.phatinv_mont, ba.ps, ba.pinv) if scaled else None
        ncoef = y.numel() // dim
        add("crt_digit_split", y.shape,
            lambda y=y, plan=plan, scale=scale: rns.digit_split(y, plan.nd, plan.inv_p, scale),
            lambda y=y, plan=plan, scale=scale: rns.plain_digit_split(y, plan.nd, plan.inv_p,
                                                                      scale),
            [y], ncoef * (plan.nd * dim + 1), IMAD_MONT * y.numel() if scaled else 0,
            af_check=True)
    # (dim, k_out, center, bound, inv_p off by a factor 1 + 2^-22: the exact
    # path's +-1 corrections must absorb it)
    cases_lift = ((dim_m, klv, True, ctx.bits_mul(L), False),
                  (dim_s, eng.kq, True, ctx.bits_swk(L), False),
                  (dim_s, None, True, None, False), (ctx.dim, None, False, None, False),
                  (dim_s, None, True, None, True))
    for dim, k_out, center, bound, skew in cases_lift:
        ba, plan = ring.ba(dim), ring.recon(dim)
        if skew:
            plan = dataclasses.replace(plan, inv_p=plan.inv_p * (1 + 2.0 ** -22))
        kd = min(2 * k_out, plan.ds) if k_out else plan.ds
        yv = res(dim)
        sd, af = rns.plain_digit_partials(yv, plan, kd)
        rows = n
        add("crt_lift", list(sd.shape) + [k_out or plan.ks],
            lambda sd=sd, af=af, plan=plan, c=center, k=k_out: rns._lift(sd, af, plan, c, k),
            lambda sd=sd, af=af, plan=plan, c=center, k=k_out: rns.plain_lift(sd, af, plan, c, k),
            [sd, af], rows * (k_out or plan.ks), rows * kd,
            # the exact path past 32 limbs (the key switch's, and the mesh's
            # reconstruct_sharded): a row of two or more chunks, timed too
            wide=k_out is None and not skew and plan.ks > 32)
        # the whole reconstruct on values within its bound (exact path: any
        # residues; fast path: |value| < 2^bound with the edge values
        # 0, +-(2^bound - 1))
        if bound is not None:
            vals = ew_limbs(rng, (n, eng.kq), device)
            vals = lb.plain_mask_bits(vals, bound - 1)
            vals[:4] = 0
            vals[1] = lb.plain_mask_bits(torch.full_like(vals[1], 0xFFFFFFFF), bound)
            vals[2] = lb.plain_neg(vals[1][None])[0]
            vals[3] = lb.plain_neg(lb.plain_mask_bits(ew_words(rng, (1, eng.kq), device, 32),
                                                      bound - 1))[0]
            r = rns.plain_decompose_signed(vals, ba.ps, ba.pinv, ring.weights(dim, eng.kq),
                                           32 * eng.kq)
        else:
            r = yv
        add("crt_lift", [f"reconstruct {list(r.shape)}"],
            lambda r=r, ba=ba, plan=plan, c=center, k=k_out, b=bound:
                rns.reconstruct(r, ba, plan, center=c, k_out=k, bound_bits=b),
            # the plain side: the same dispatcher on CPU copies, where it
            # picks the plain versions
            lambda r=r, ba=ew_cpu(ba), plan=ew_cpu(plan), c=center, k=k_out, b=bound:
                rns.reconstruct(r.cpu(), ba, plan, center=c, k_out=k,
                                bound_bits=b).to(r.device),
            [r], n * (k_out or plan.ks), 0, timed=False)

    # K7 limbs
    qb, logD = eng.qbits(L), ctx.p.bit_length() - 1
    for lead in ((), (B,)):
        a, b = ew_limbs(rng, lead + (n, klv), device), ew_limbs(rng, lead + (n, klv), device)
        for op in ("add", "sub"):
            add(f"limbs_{op}", a.shape, lambda a=a, b=b, op=op: getattr(lb, op)(a, b),
                lambda a=a, b=b, op=op: getattr(lb, f"plain_{op}")(a, b), [a, b], a.numel(), 0)
    a, b = ew_limbs(rng, (n, klv), device), ew_limbs(rng, (n, klv), device)
    bit = torch.from_numpy(rng.integers(0, 2, size=n).astype(bool)).to(device)
    bit[:3] = True
    c = a[5].clone()
    # mask_bits' constant of limb masks: one torch & computes that entry
    full, rem = divmod(qb - 3, 32)
    mask = torch.tensor([0xFFFFFFFF] * full + [(1 << rem) - 1] + [0] * (klv - full - 1),
                        dtype=torch.int64, device=device)
    # (op, args, words written: geq_const one bool a row, the rescale
    # kl(L - 1) limbs a row; library: one PyTorch call of the same function)
    kr = eng.kl(L - 1)
    one = [("neg", (a,), a.numel(), None, None),
           ("add_scalar_bit", (a, bit), a.numel(), None, None),
           ("select", (bit, a, b), a.numel(), lambda: torch.where(bit[:, None], a, b), None),
           ("geq_const", (a, c), n / 8, None, geq_read_bytes(a, c)),
           ("mask_bits", (a, qb - 3), a.numel(), lambda: a & mask, None),
           ("rshift_round", (a, logD), a.numel(), None, None),
           ("rshift_round_mask", (a, logD, eng.qbits(L - 1), kr), n * kr, None, None)]
    for op, args, out_words, library, read in one:
        add(f"limbs_{op}", a.shape, lambda op=op, args=args: getattr(lb, op)(*args),
            lambda op=op, args=args: getattr(lb, f"plain_{op}")(*args),
            [t for t in args if torch.is_tensor(t)], out_words, 0, read_bytes=read,
            library=library)
    # geq_const on the wide rows the paths compare (62 and 125 limbs: two and
    # four chunks), timed too
    for kw in (125, 62):
        wide = ew_limbs(rng, (n, kw), device)
        cw = wide[7].clone()
        cw[:kw - 25] = wide[8, :kw - 25]      # rows 7 and 8 differ in the low limbs only
        add("limbs_geq_const", wide.shape, lambda wide=wide, cw=cw: lb.geq_const(wide, cw),
            lambda wide=wide, cw=cw: lb.plain_geq_const(wide, cw), [wide, cw], n / 8, 0,
            read_bytes=geq_read_bytes(wide, cw), wide=True)
    kq = eng.kq
    dg = torch.from_numpy(rng.integers(0, 1 << 48, size=(n, 2 * kq)).astype(np.float64)).to(device)
    dg[0] = float((1 << 48) - 1)
    add("limbs_from_digits16", dg.shape, lambda: lb.from_digits16(dg, kq),
        lambda: lb.plain_from_digits16(dg, kq), [dg], n * kq, 0)
    return cases


# K at the edges of K7's designs: one limb, around a warp, the paths' 14
# and 28, geq_const's 62, 63, 68, 124 and 125, a whole number of chunks of
# 32 limbs and one more (64, 65, 129), and a row of 96 chunks (3071)
EDGE_K = (1, 13, 14, 28, 31, 32, 33, 62, 63, 64, 65, 68, 124, 125, 129, 3071)
# rows of every edge case: two full blocks and a partial one wherever a
# block takes at most 256 rows (4 warps x 4 rows a lane x 16 groups of a
# warp at one limb), and a partial block at every K (a block's rows are a
# power of 2)
EDGE_ROWS = 2 * 256 + 7


def elementwise_edge_cases(device, seed: int = 9) -> list:
    """K7 and the CRT lift at the edges of their designs, each a dict with
    entry, shape, kern and plain (the plain version on the same tensors):
    every entry at every K of EDGE_K on EDGE_ROWS rows, edge rows first (a
    carry and a borrow through every limb, equal rows, rows equal but for
    the top limb); operands read through cuda_build.strides3 in every form:
    a constant row (stride 0), an operand broadcast over a leading axis
    (R1 > 1, the rows do not collapse), row-strided and limb-strided views,
    per-row bits as bool and int64; the lift at one, two and four chunks of
    32 limbs (3-120 limbs on the exact path, up to 128 on the fast one), f64
    and int64 digit sums, odd kd, kd < 2 k_out and random estimates that
    reach both clamps and both sides of the 1/2 rule."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ops import limbs as lb
    from gpqhe_tpu_torch.ops import rns

    rng = np.random.default_rng(seed)
    cases = []
    rows = EDGE_ROWS

    def add(op, shape, *args):
        """A case of ops/limbs.py's `op` (or the lift, `_lift`) on args."""
        mod = rns if op == "_lift" else lb
        plain = "plain_lift" if op == "_lift" else f"plain_{op}"
        cases.append(dict(entry="crt_lift" if op == "_lift" else f"limbs_{op}",
                          shape=list(shape), op=op, args=args,
                          kern=lambda: getattr(mod, op)(*args),
                          plain=lambda: getattr(mod, plain)(*args)))

    def limbs(shape):
        """u32 limbs, rows 0-2 all 0xFFFFFFFF, all 0, and 0xFFFFFFFF below a
        zero top limb (at any K, one included)."""
        x = rng.integers(0, 1 << 32, size=shape, dtype=np.int64)
        x[..., 0, :] = 0xFFFFFFFF
        x[..., 1, :] = 0
        x[..., 2, :] = 0xFFFFFFFF
        x[..., 2, -1] = 0
        return torch.from_numpy(x).to(device)

    for k in EDGE_K:
        a, b = limbs((rows, k)), limbs((rows, k))
        b[0] = 0
        b[0, 0] = 1                   # 0xFF..FF + 1: a carry through every limb
        b[1] = b[0]                   # 0 - 1: a borrow through every limb
        b[3] = a[3]
        b[4] = a[4]
        b[4, -1] ^= 1                 # equal but for the top limb
        bit = torch.from_numpy(rng.integers(0, 2, size=rows).astype(bool)).to(device)
        bit[0] = True
        for op, args in (("add", (a, b)), ("sub", (a, b)), ("neg", (a,)),
                         ("add_scalar_bit", (a, bit)), ("select", (bit, a, b)),
                         ("geq_const", (a, b)), ("geq_const", (a, a[4].clone())),
                         ("mask_bits", (a, 32 * k - 5)), ("mask_bits", (a, 16 * k + 7)),
                         ("rshift_round", (a, min(50, 32 * k - 1), k + (k < 1000))),
                         ("rshift_round", (a, 5, k)),
                         ("rshift_round_mask", (a, min(50, 32 * k - 1), max(1, 32 * k - 60),
                                                max(1, k - 1)))):
            add(op, a.shape, *args)
        if k > 1000:
            continue
        d = torch.from_numpy(rng.integers(0, 1 << 48, size=(rows, 2 * k + 3)).astype(np.float64))
        d[0] = 0xFFFF                 # every digit propagates a carry made at the bottom
        d[0, 0] = 0x10000
        d[1] = float((1 << 48) - 1)
        d = d.to(device)
        for dg, kout in ((d, k), (d.to(torch.int64), k), (d[:, :2 * k - 1], k + 1)):
            add("from_digits16", dg.shape, dg, kout)

    # operand layouts through strides3, at K = 14 and 125 (R1 = 2 leading rows)
    for k in (14, 125):
        a, base = limbs((2, rows, k)), limbs((rows, 2 * k + 3))
        views = {"const": a[1, 5].clone(), "lead_broadcast": base[:, :k],
                 "limb_strided": base[:, 1:2 * k + 1:2]}
        for name, b in views.items():
            for op in ("add", "sub", "geq_const"):
                add(op, [name] + list(a.shape), a, b)
        av = base[:, 2:k + 2]         # rows 2k + 3 words apart
        mask = torch.from_numpy(rng.integers(0, 2, size=rows).astype(bool)).to(device)
        bits = mask.to(torch.int64)[None].repeat(2, 1)
        for op, args in (("neg", (av,)), ("add_scalar_bit", (a, bits)),
                         ("select", (mask, a, views["const"])), ("select", (mask, a, av)),
                         ("mask_bits", (views["limb_strided"], 32 * k - 9)),
                         ("rshift_round_mask", (av, 50, 32 * k - 70, k - 1))):
            add(op, ["views", k], *args)
        add("from_digits16", ["views", k], base[:, :2 * k].to(torch.float64)[:, ::2], k // 2)

    # the lift: (logp, dim, k_out (None: exact, the plan's ks limbs), kd (None:
    # the plan's), center); ks = 3, 16, 31, 33, 64, 66, 114 on the 59-bit
    # chain at dim 1, 8, 16, 17, 34, 35, 61 and 30, 32 on logp=29 at 31, 34
    n = 1 << 10
    rings = {59: PolyContext(10, q=1 << 20, dim_cap=72),
             29: PolyContext(10, q=1 << 20, logp=29, dim_cap=72)}
    R = rows
    for logp, dim, k_out, kd, center in (
            (59, 1, None, None, True), (59, 8, None, None, False), (59, 16, None, None, True),
            (59, 17, None, None, True), (59, 34, None, None, False), (59, 35, None, None, True),
            (59, 61, None, None, True), (29, 31, None, None, True), (29, 34, None, None, True),
            (59, 8, 5, 9, True), (59, 8, 16, None, True), (29, 16, 7, 14, True),
            (59, 24, 32, None, True), (59, 24, 33, 61, True), (59, 69, 128, None, False)):
        ring = rings[logp]
        plan = rns.make_recon_plan(ring, dim, device)
        ba = rns.make_basis_arrays(ring, dim, device)
        kd = kd or (plan.ds if k_out is None else min(2 * k_out, plan.ds))
        y = ew_residues(rng, ring.primes[:dim], (dim, n), device)
        sd, af = rns.plain_digit_partials(y, plan, kd, (ba.phatinv_mont, ba.ps, ba.pinv))
        sd, af = sd[:R], af[:R]
        noisy = torch.from_numpy(rng.uniform(-1.5, dim + 1.5, size=R)).to(device)
        sr = torch.from_numpy(rng.integers(0, 1 << 48, size=(R, kd)).astype(np.float64)).to(device)
        for s_, a_ in ((sd, af), (sd.to(torch.int64), af), (sr, noisy)):
            add("_lift", [logp, dim, k_out, R, kd, str(s_.dtype)], s_, a_, plan, center, k_out)
    return cases + rns_edge_cases(device, rings) + modmath_edge_cases(device, rings)


# decompose at the edges of its design: (logp, dim, K, src_bits, layout): dims
# around its tiles of 16 primes (1-47), K = 1 (the c1 of a one-weight row),
# 2, odd K, 64 and 65 and 125 (one and two staged chunks of 64 limbs), 300
# (a reduction after 256 limbs and a second group), src_bits at 1, 32 K - 5
# and 32 K; on the three widths of prime (one, two and three 24-bit chunks a
# constant); S = 0, three slabs, a row broadcast over two slabs, rows 2K + 3
# words apart and limbs two words apart (copied by the wrapper)
DECOMPOSE_EDGES = (
    (59, 16, 14, None, "lead"), (59, 17, 13, None, "plain"), (59, 47, 28, 32 * 28, "plain"),
    (59, 31, 28, 32 * 28 - 5, "row_strided"), (59, 8, 1, None, "plain"), (59, 8, 1, 1, "plain"),
    (59, 33, 2, 59, "broadcast"), (59, 16, 125, None, "plain"),
    (59, 16, 125, 32 * 125 - 5, "limb_strided"), (59, 5, 64, 32 * 64, "plain"),
    (59, 5, 65, 1, "plain"), (59, 3, 300, None, "plain"), (59, 3, 300, 32 * 300, "plain"),
    (59, 16, 14, None, "S0"), (29, 31, 14, None, "plain"), (29, 47, 28, 32 * 28 - 5, "lead"),
    (29, 16, 1, 1, "plain"), (29, 20, 125, 32 * 125, "broadcast"), (9, 6, 3, None, "plain"),
    (9, 6, 14, 32 * 14, "lead"), (9, 5, 1, 1, "plain"), (9, 6, 125, 32 * 125 - 5, "plain"),
    (9, 6, 300, None, "row_strided"))
# the digit split at the edges of its design: (logp, dim, n, lead, scaled,
# layout): n a multiple of the block's 64 coefficients, even but not (the
# 16-byte pairs, a partial block) and odd (word stores), dims around its 8
# warps of primes (1-47), nd = 4, 2 and 1 digits (the three chains); S = 0,
# residues broadcast over two slabs, a prime slice of a wider stack, every
# other coefficient (word loads), a view one word off 16-byte alignment, a
# strided inv_p, and a mesh shard's plan whose rows past the basis have
# inv_p = 0 (make_recon_plan(rows=...))
SPLIT_EDGES = (
    (59, 16, 1024, (), False, "plain"), (59, 16, 518, (), True, "plain"),
    (59, 17, 519, (), True, "plain"), (59, 47, 1024, (3,), True, "plain"),
    (59, 1, 519, (), False, "plain"), (59, 9, 64, (2,), True, "plain"),
    (59, 16, 518, (), False, "S0"), (59, 24, 518, (), True, "broadcast"),
    (59, 16, 1024, (), True, "prime_slice"), (59, 17, 518, (), False, "coef_strided"),
    (59, 16, 518, (2,), True, "unaligned"), (59, 8, 1024, (), False, "inv_p_strided"),
    (59, 8, 518, (), False, "shard"), (29, 31, 518, (), True, "plain"),
    (29, 47, 519, (2,), False, "plain"), (29, 16, 1024, (), True, "unaligned"),
    (9, 6, 16, (), True, "plain"), (9, 5, 519, (), False, "plain"),
    (9, 6, 518, (3,), True, "broadcast"))


def rns_edge_cases(device, rings: dict, seed: int = 10) -> list:
    """decompose and the digit split at the edges of their designs
    (DECOMPOSE_EDGES, SPLIT_EDGES), each a dict with entry, shape, op and
    args (ops/rns_cuda.py's entry and its arguments), kern (the dispatcher)
    and plain (the plain version on the same tensors).  decompose's rows:
    EDGE_ROWS (a partial block of 64), the first all 0xFFFFFFFF, all 0 and
    0xFFFFFFFF below a zero top limb, then the sign bit alone, all bits
    below it, and p - 1, p, p + 1 of the first prime (where K holds them)."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ops import rns
    from gpqhe_tpu_torch.substrate import bigint

    rng = np.random.default_rng(seed)
    rings = dict(rings)
    rings[9] = PolyContext(4, **CRT_CHAIN)
    cases = []

    def case(entry, shape, op, args, kern, plain):
        cases.append(dict(entry=entry, shape=list(shape), op=op, args=args, kern=kern,
                          plain=plain))

    rows = EDGE_ROWS
    for logp, dim, k, src, layout in DECOMPOSE_EDGES:
        ring = rings[logp]
        x = rng.integers(0, 1 << 32, size=(rows, k), dtype=np.int64)
        x[0], x[1], x[2] = 0xFFFFFFFF, 0, 0xFFFFFFFF
        x[2, -1] = 0
        top = (src or 32 * k) - 1
        p0 = ring.primes[0]
        for r, v in enumerate((1 << top, (1 << top) - 1, p0 - 1, p0, p0 + 1), start=3):
            if v < 1 << (32 * k):
                x[r] = bigint.int_to_limbs(v, k).astype(np.int64)
        a = torch.from_numpy(x).to(device)
        if layout == "lead":
            a = torch.stack([a, a.flip(0), a.flip(1)])
        elif layout == "S0":
            a = a[None][:0]
        elif layout == "broadcast":
            a = a[None].expand(2, rows, k)
        elif layout == "row_strided":
            a = torch.cat([a, a[:, :k + 3]], dim=1)[:, :k]
        elif layout == "limb_strided":
            a = torch.stack([a, a], dim=-1).reshape(rows, 2 * k)[:, ::2]
        ba = rns.make_basis_arrays(ring, dim, device)
        w = torch.from_numpy(rns.make_decomp_weights(ring, dim, k).view(np.int64)).to(device)
        args = (a, ba.ps, ba.pinv, w, src)
        plain = ((lambda a=a, ba=ba, w=w: rns.plain_decompose_core(a, ba.ps, ba.pinv, w))
                 if src is None else
                 (lambda a=a, ba=ba, w=w, src=src:
                  rns.plain_decompose_signed(a, ba.ps, ba.pinv, w, src)))
        case("decompose", [logp, dim, src, layout] + list(a.shape), "decompose", args,
             lambda args=args: rns.decompose_core(*args), plain)

    for logp, dim, n, lead, scaled, layout in SPLIT_EDGES:
        ring = rings[logp]
        rows_ = dim + 3 if layout == "prime_slice" else dim
        plan = rns.make_recon_plan(ring, dim, device)
        ba = rns.make_basis_arrays(ring, rows_, device)
        wide = {"coef_strided": 2 * n, "unaligned": n + 1}.get(layout, n)
        y = ew_residues(rng, ring.primes[:rows_], lead + (rows_, wide), device)
        if layout == "prime_slice":
            y = y[..., :dim, :]
        elif layout == "coef_strided":
            y = y[..., ::2]
        elif layout == "unaligned":
            y = y[..., 1:]
        elif layout == "broadcast":
            y = y[None].expand((2,) + y.shape)
        elif layout == "S0":
            y = y[None][:0]
        inv_p = plan.inv_p
        if layout == "inv_p_strided":
            inv_p = torch.stack([inv_p, inv_p + 1], dim=-1)[:, 0]
        elif layout == "shard":
            # rows 4 .. dim + 3 of the basis: the last 4 past it
            plan = rns.make_recon_plan(ring, dim, device, rows=(4, dim + 4))
            inv_p = plan.inv_p
            y = ew_residues(rng, ring.primes[4:dim + 4], (dim, n), device)
        scale = (ba.phatinv_mont[:dim], ba.ps[:dim], ba.pinv[:dim]) if scaled else None
        args = (y, plan.nd, inv_p, scale)
        case("crt_digit_split", [logp, plan.nd, scaled, layout] + list(y.shape), "digit_split",
             args, lambda args=args: rns.digit_split(*args),
             lambda args=args: rns.plain_digit_split(*args))
    return cases


# K5's elementwise kernel (mulmod, mont_mul, addmod, submod, to_mont) at the
# edges of its design: (logp, dim, leading axes, n, layout).  n around a
# block's 1024 words and a thread's 4 in 16-byte pairs (1, 5, 518, 1030,
# 2050: tails; 16, 1024: whole blocks); A past the grid's 65535; the three
# widths of prime; layouts: "offset" x and y one word into rows n + 1 words
# apart (row 0 off 16-byte alignment, then every other row), "const_n" y and
# "const_x" x a per-row constant (stride 0 along n), "bcast_a" y broadcast
# over the leading axis, "bcast_d" y one row broadcast over the primes,
# "bank_rows" and "bank_cols" y the key bank's [:dim] and [:, :dim] slices,
# "strided" every other word (word loads), "words" mont_mul of any u64
# words (0, 2^63, 2^64 - 1 among them) against y < p
MODMATH_EDGES = (
    (59, 3, (), 1, "plain"), (59, 3, (), 5, "plain"), (59, 5, (), 1024, "plain"),
    (59, 3, (2,), 1030, "plain"), (59, 2, (), 2050, "plain"), (59, 1, (65537,), 2, "plain"),
    (59, 3, (), 1024, "offset"), (59, 3, (2,), 518, "offset"), (59, 3, (2,), 1024, "const_n"),
    (59, 3, (), 1030, "const_x"), (59, 3, (2,), 1024, "bcast_a"), (59, 3, (), 1030, "bcast_d"),
    (59, 5, (), 1024, "bank_rows"), (59, 5, (EW_N1,), 1030, "bank_cols"),
    (59, 3, (), 1026, "strided"), (59, 3, (2,), 1030, "words"),
    (29, 4, (2,), 1030, "plain"), (29, 3, (), 1024, "offset"), (29, 3, (), 518, "const_n"),
    (29, 3, (), 1024, "words"),
    (9, 6, (), 16, "plain"), (9, 5, (2,), 1030, "plain"), (9, 6, (), 1024, "offset"),
    (9, 6, (), 1030, "bcast_d"), (9, 6, (), 1024, "words"))


def modmath_edge_cases(device, rings: dict, seed: int = 11) -> list:
    """K5's elementwise entries at the edges of its design (MODMATH_EDGES),
    each a dict with entry, shape, op and args (ops/modmath_cuda.py's
    `elementwise` and its arguments), kern (the dispatcher) and plain (the
    plain version on the same tensors); residues carry the edge words 0, 1
    and p - 1."""
    import numpy as np
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ops import modmath as mm
    from gpqhe_tpu_torch.ops import rns

    rng = np.random.default_rng(seed)
    rings = dict(rings)
    rings[9] = PolyContext(4, **CRT_CHAIN)
    cases = []
    for logp, dim, lead, n, layout in MODMATH_EDGES:
        primes = rings[logp].primes
        ba = rns.make_basis_arrays(rings[logp], dim, device)
        p, pinv, r2 = ba.ps[:, None], ba.pinv[:, None], ba.r2[:, None]

        def res(rows, lead=lead, width=n):
            return ew_residues(rng, primes[:rows], lead + (rows, width), device)
        x, y = res(dim), res(dim)
        if layout == "offset":
            x, y = res(dim, width=n + 1)[..., 1:], res(dim, width=n + 1)[..., 1:]
        elif layout == "const_n":
            y = res(dim, width=1)
        elif layout == "const_x":
            x = res(dim, width=1)
        elif layout == "bcast_a":
            x, y = res(dim, lead=(2,) + lead), res(dim)
        elif layout == "bcast_d":
            y = ew_residues(rng, [min(primes[:dim])], lead + (1, n), device)
        elif layout == "bank_rows":
            y = res(dim + 3)[..., :dim, :]
        elif layout == "bank_cols":
            y = res(dim + 3)[:, :dim]
        elif layout == "strided":
            x, y = res(dim, width=2 * n)[..., ::2], res(dim, width=2 * n)[..., 1::2]
        elif layout == "words":
            x = ew_words(rng, lead + (dim, n), device)
        ops = (("mont_mul",) if layout == "words" else
               ("mulmod", "mont_mul", "addmod", "submod", "to_mont"))
        for op in ops:
            consts = {"mulmod": (p, pinv, r2), "mont_mul": (p, pinv), "addmod": (p,),
                      "submod": (p,), "to_mont": (p, pinv, r2)}[op]
            # the dispatcher's arguments, and the wrapper's (to_mont: x against r2)
            xs = (x,) + consts if op == "to_mont" else (x, y) + consts
            args = (op, x, r2, p, pinv) if op == "to_mont" else (op,) + xs
            cases.append(dict(
                entry=f"modmath_{op}", shape=[logp, layout] + list(x.shape), op="elementwise",
                args=args, kern=lambda f=getattr(mm, op), xs=xs: f(*xs),
                plain=lambda f=getattr(mm, f"plain_{op}"), xs=xs: f(*xs)))
    return cases


def ew_cpu(consts):
    """A copy of a frozen dataclass of constants (BasisArrays, ReconPlan)
    with every tensor on the CPU."""
    import dataclasses

    import torch
    return dataclasses.replace(consts, **{
        f.name: getattr(consts, f.name).cpu() for f in dataclasses.fields(consts)
        if torch.is_tensor(getattr(consts, f.name))})


def ew_compare(got, want) -> tuple[bool, float, dict]:
    """(equal, max_abs_err, extra) of a kernel's output against the plain
    version's: torch.equal on every tensor; for digit_split the f64 af
    estimate (summed in another order) is held to a relative 2^-45
    instead (its use tolerates far more: ops/rns.py reconstruct_core)."""
    import torch
    if isinstance(got, tuple):
        Y, af = got
        pY, paf = want
        if not af.numel():             # no coefficients (S = 0)
            return bool(torch.equal(Y, pY) and torch.equal(af, paf)), 0.0, {"af_max_rel": 0.0}
        rel = float(((af - paf).abs() / paf.abs().clamp_min(1e-300)).max().item())
        eq = bool(torch.equal(Y, pY)) and rel <= 2.0 ** -45
        return eq, float((Y - pY).abs().max().item()), {"af_max_rel": rel}
    if got.dtype == torch.bool:
        return bool(torch.equal(got, want)), float((got != want).sum().item()), {}
    eq = bool(torch.equal(got, want))
    err = 0.0 if eq else float((got.to(torch.float64) - want.to(torch.float64)).abs().max().item())
    return eq, err, {}


def ew_bound(case) -> dict:
    t_bytes = case["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = case["imad"] / PEAK_IMAD_S * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_ms": t_bytes, "operations_ms": t_ops}
    if "imad_mont" in case:
        out["mont_operations_ms"] = case["imad_mont"] / PEAK_IMAD_S * 1e3
    return out


def boot15_key(entry: str, dim: int, lead: tuple, nw: int) -> str:
    """ew_counters' key of a BOOT15_K5 shape class."""
    return f"{entry} {list(lead) + [dim, 1 << 15]}" + (f" x{nw}" if nw else "")


def retimed15(entry: str) -> tuple:
    """The cases (indices into elementwise_cases' list of the entry) timed
    at logn=15 too (`kernels15` lines): K7 and the lift, whose rows are 28
    limbs wide there, at their main shape; decompose into the product's
    and the key switch's bases ([2^15, 28] -> 31 and 47 primes); the digit
    split of the product's three polys and of the key switch's exact
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


def host_dispatches(events) -> dict:
    """The host's calls that put work on the device, from a profile's CUDA
    runtime events: graph launches, copies (and fills), kernel launches."""
    out = {"graph_launches": 0, "copies": 0, "kernel_launches": 0}
    for e in events:
        if e.name.startswith(("cudaGraphLaunch", "cuGraphLaunch")):
            out["graph_launches"] += 1
        elif e.name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")):
            out["copies"] += 1
        elif e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            out["kernel_launches"] += 1
    return out


def profile_op(op: str, fn, host_ops: bool = True, warm: bool = True, **tags):
    """One call of fn under torch.profiler: device busy time, the NTT
    kernels' share of it, the number of device kernels, and the device idle
    share of the host wall time; with host_ops the host's dispatches
    (host_dispatches).  host_ops=False records the device only (a call of
    some 10^5 launches would otherwise log every host operator); warm=False
    skips the call before the capture (fn has just run).  Returns the
    emitted line."""
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
    host = {"host_dispatches": host_dispatches(prof.events())} if host_ops else {}
    if not kernels or busy_us <= 0:
        line = {"phase": "profile", "op": op, **tags, "device_time": "not measured", **host}
        emit(line)
        return line
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    modules = [kernel_module(e.name) for e in kernels]
    ntt_us = sum(e.time_range.elapsed_us() for e, m in zip(kernels, modules)
                 if m.startswith("ntt"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    by_module, modmath = {}, {}
    for e, module in zip(kernels, modules):
        for key, into in ((module, by_module), (modmath_entry(e.name), modmath)):
            if key:
                m = into.setdefault(key, {"launches": 0, "ms": 0.0})
                m["launches"] += 1
                m["ms"] += e.time_range.elapsed_us() / 1e3
    line = {"phase": "profile", "op": op, **tags, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / wall_us, "device_kernels": len(kernels),
            "ntt_kernels": sum(1 for m in modules if m.startswith("ntt")),
            "ntt_ms": ntt_us / 1e3, "ntt_share_of_busy": ntt_us / busy_us,
            "by_module": by_module, "modmath_by_entry": modmath, **host,
            "top_ms": [[k[:60], v / 1e3] for k, v in top]}
    emit(line)
    return line


def kernel_module(name: str) -> str:
    """The module whose kernel a device kernel's name is: ntt (csrc/ntt.cu,
    ntt32.cu), ntt4 (the four-step stage, csrc/ntt4.cu), modmath, "rns
    <entry>" (decompose, digit_split or lift) or limbs (the elementwise
    kernels, named by their prefix), "matmul" (torch's matrix products: the
    f64 digit matmuls of the reconstructs), "copies" (the device's copies
    and fills: a graph's static inputs and the clones of its outputs), else
    "other torch" (torch's other kernels: stacks, gathers, the plain
    chains)."""
    import re
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if re.search(r"(?<![A-Za-z_])ntt_(col|row)_pass", name):
        return "ntt"
    if re.search(r"(?<![A-Za-z_])ntt4_stage_kernel", name):
        return "ntt4"
    m = re.search(r"(?<![A-Za-z_])rns_(decompose|digit_split|lift)_kernel", name)
    if m:
        return f"rns {m.group(1)}"
    m = re.search(r"(?<![A-Za-z_])(mm|limbs)_[a-z_]*kernel", name)
    if m:
        return {"mm": "modmath", "limbs": "limbs"}[m.group(1)]
    if re.search(r"gemm|gemv|matmul", name, flags=re.I):
        return "matmul"
    return "other torch"


def modmath_entry(name: str):
    """The K5 entry a device kernel's name is (mm_ew_kernel by its op:
    "mont_mul" covers to_mont; the sum by mode: "mulmod_sum" both modes
    with products), or None for any other kernel."""
    import re
    m = re.search(r"(?<![A-Za-z_])mm_(ew|cross|keyprod|sum)_kernel(?:<(\d)>|ILi(\d)E)?", name)
    if not m:
        return None
    mode = int(m.group(2) or m.group(3) or 0)
    return {"ew": ("mont_mul", "mulmod", "addmod", "submod")[mode], "cross": "cross_terms",
            "keyprod": "key_products",
            "sum": "summod" if mode == 0 else "mulmod_sum"}[m.group(1)]


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
    ew_reset()
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
    launches, ew = dict(ntt_cuda.LAUNCHES), ew_counters()

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
          "elementwise_launches": {k: v for k, v in ew.items() if v},
          "operand_copies": ew_copies(),
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    if not shape_ok:
        raise AssertionError("mul_rs output has the wrong shape or non-finite slots")
    if not diff < 1e-5:
        raise AssertionError(f"mul_rs decode diff {diff} >= 1e-5")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the main path never launched NTT entries {missing}")
    require_ew_launches("mul_rs", ew)
    return {"launches": launches, "elementwise": ew}


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
    ew_reset()
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
    launches, foreign, ew = dict(mine), dict(other), ew_counters()

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
    pt2 = eng.ecd(m2)
    times = {
        "mul_rs_ms": cuda_ms(lambda: eng.mul_rs(ct, ct2, rlk), few),
        "mulpt_ms": cuda_ms(lambda: eng.mulpt(ct, pt2), few),
        "rot_ms": cuda_ms(lambda: eng.rot(ct, 1, rk), few),
        "conj_ms": cuda_ms(lambda: eng.conj(ct, ck), few),
        "mul_rs_batch_ms_per_ct": cuda_ms(lambda: eng.mul_rs_batch(cts1, cts2, rlk), few) / BATCH,
        "gemv_full_ms": cuda_ms(lambda: linalg.gemv_hoisted(eng, plan, ct, rk), few),
        "gemv_bsgs_ms": cuda_ms(lambda: linalg.gemv_hoisted(eng, plan, ct, bank), few),
    }
    for op, fn in (("mulpt", lambda: eng.mulpt(ct, pt2)), ("rot", lambda: eng.rot(ct, 1, rk)),
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
          "elementwise_launches": {k: v for k, v in ew.items() if v},
          "operand_copies": ew_copies(),
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
    require_ew_launches(name, ew)

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
    return {"launches": launches, "errs": errs, "decoded": got, "elementwise": ew,
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


MESH_HEADS = {"mul_rs": "mul_rs", "rot": "rot", "conj": "rot", "gemv_full": "gemvstep"}


def mesh_programs(meng, op: str, l: int) -> list:
    """The sharded programs that MeshCKKS built for op at level l (the gemv:
    every giant step's)."""
    head = MESH_HEADS[op]
    want = {"rot": 1, "conj": None}.get(op)
    return [p for k, p in meng._mesh_jit.items()
            if k[0] == head and k[1] == l and (head != "rot" or k[2] == want)]


def mesh_graphed(meng, op: str, l: int) -> bool:
    """Whether op's sharded programs run as CUDA graphs (and have some)."""
    from gpqhe_tpu_torch.utils import graphs
    progs = mesh_programs(meng, op, l)
    return bool(progs) and all(isinstance(p, graphs.Program) and p.graphs for p in progs)


def mesh_replays_match(fn, inputs: list, mesh, name: str) -> dict:
    """The launch counters' and the mesh's traffic gain over one graphed call
    of fn on each input set (replays) against as many calls under
    graphs.disabled(): equal, or raises.  Returns the gains."""
    from gpqhe_tpu_torch.utils import graphs
    out = {}
    for mode in ("graphed", "eager"):
        mesh.reset_traffic()
        before = graphs.counters_snapshot()
        with graphs.disabled() if mode == "eager" else contextlib.nullcontext():
            for x in inputs:
                fn(x)
        out[mode] = {"launches": launch_counters_delta(before),
                     "traffic": {c: list(v) for c, v in mesh.traffic.items()}}
    if out["graphed"] != out["eager"]:
        raise AssertionError(f"mesh {name}: {len(inputs)} replays counted {out['graphed']}, "
                             f"as many eager calls {out['eager']}")
    return out["graphed"]


def mesh_chain(logp: int, iters: int, devices, what: str) -> dict:
    """mul_rs, rot(1), conj and the fully hoisted gemv at logn=14/logq=438/
    slots=16/Delta=2^50 on a (2,2,2) mesh against the single-device engine
    on the same keys; each op's sharded programs graphed (HeMesh.graphable)
    against the same under graphs.disabled(), in turns; then the sharded
    3-D poly_mul (mesh_poly_mul).  Returns the NTT and the elementwise
    launches of one call of each mesh op."""
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
    x0 = {"ct": eng.enc_pk(eng.ecd(v), pk), "ct2": eng.enc_pk(eng.ecd(m2), pk)}
    plans = {e: linalg.HoistedGemvPlan(e, A) for e in (eng, meng)}

    def fresh(seed: int) -> dict:
        r = np.random.default_rng(seed)
        return {k: eng.enc_pk(eng.ecd(r.random(ctx.slots) + 1j * r.random(ctx.slots)), pk)
                for k in ("ct", "ct2")}

    def ops(e):
        return {"mul_rs": lambda x: e.mul_rs(x["ct"], x["ct2"], rlk),
                "rot": lambda x: e.rot(x["ct"], 1, rk), "conj": lambda x: e.conj(x["ct"], ck),
                "gemv_full": lambda x: linalg.gemv_hoisted_full(e, plans[e], x["ct"], rk)}
    want = {"mul_rs": v * m2, "rot": np.roll(v, -1), "conj": np.conj(v),
            "gemv_full": A.reshape(ctx.slots, ctx.slots) @ v}
    t1 = time.time()
    single = {k: fn(x0) for k, fn in ops(eng).items()}
    sharded = {k: fn(x0) for k, fn in ops(meng).items()}     # builds and captures the programs
    torch.cuda.synchronize()
    first_s = time.time() - t1
    l = x0["ct"].l
    graphed = {k: mesh_graphed(meng, k, l) for k in sharded}
    equal = {k: graph_same(single[k], sharded[k]) for k in single}
    diffs = {k: float(np.max(np.abs(eng.dcd(eng.dec(c, sk)) - want[k])))
             for k, c in sharded.items()}

    # graphed against eager and against the single device on fresh inputs
    inputs = [x0] + [fresh(seed) for seed in (1, 2)]
    replayed = {}
    for k, fn in ops(meng).items():
        name = f"{k} logp={logp}"
        graph_check(fn, inputs, f"mesh {name}")
        for i, x in enumerate(inputs):
            if not graph_same(fn(x), ops(eng)[k](x)):
                raise AssertionError(f"mesh {name}: input {i} differs from the single device")
        replayed[k] = mesh_replays_match(fn, inputs, mesh, name)

    # the mesh engine's main path: one call of each mesh op, programs built,
    # the counters zeroed just before and read just after
    mine, other = chain_counters(logp)
    ew_reset()
    traffic = {}
    for k, fn in ops(meng).items():
        mesh.reset_traffic()
        fn(x0)
        traffic[k] = {kind: list(c) for kind, c in mesh.traffic.items()}
    torch.cuda.synchronize()
    launches, foreign, ew = dict(mine), dict(other), ew_counters()
    P = len(mesh.positions)
    # a position: mul_rs 2 forward (four ciphertext polys in one launch, d2) and
    # 2 inverse (three cross terms, two key-switch halves); rot and conj 1 + 1;
    # the gemv step 2 inverse, its prologue 2 forward on the first device
    expected = {"fwd": 2 * P + P + P + 2, "inv": 2 * P + P + P + 2 * P, "inv_scaled": 0}

    few = max(3, iters // 4)
    turns, per_op = {}, {}
    for k, fn in ops(meng).items():
        def call(fn=fn):
            return fn(x0)
        w = [cuda_ms(eager(call), few, warmup=1), cuda_ms(call, few), cuda_ms(call, few),
             cuda_ms(eager(call), few, warmup=1)]
        turns[k] = {"eager": [w[0], w[3]], "graphed": w[1:3]}
        prof = {mode: profile_op(k, f, warm=False, logp=logp, mesh=[2, 2, 2], mode=mode)
                for mode, f in (("graphed", call), ("eager", eager(call)))}
        per_op[k] = {"graphed": graphed[k], "wall_ms_eager": turns[k]["eager"],
                     "wall_ms_graphed": turns[k]["graphed"],
                     "host_us_graphed": host_us(call, 20), "host_us_eager": host_us(eager(call), 5),
                     "replays_counted": replayed[k]["traffic"]}
        for mode, pr in prof.items():
            wall = sum(turns[k][mode]) / 2
            busy = pr.get("device_busy_ms")
            per_op[k][mode] = {"busy_ms": busy, "device_ops": pr.get("device_kernels"),
                               "idle_share": None if busy is None else 1 - busy / wall,
                               "host_dispatches": pr.get("host_dispatches")}
    ms = {"single": {k: cuda_ms(lambda fn=fn: fn(x0), few) for k, fn in ops(eng).items()},
          "mesh": {k: min(t["graphed"]) for k, t in turns.items()}}
    emit({"phase": "mesh", "logp": logp, "logn": 14, "logq": 438, "slots": 16, "logDelta": 50,
          "mesh": dict(mesh.shape), "devices": what, "L": ctx.L,
          "graphable": mesh.graphable, "eager_why": mesh.eager_why,
          "dim_mul_padded": meng._pad_limb(ctx.dim_mul(l)),
          "dim_swk_padded": meng._pad_limb(ctx.dim_swk(l)), "dimswk_h": eng.dimswk_h,
          "gemv_dims": list(meng.gemv_dims(l, plans[meng].bound_max_full(meng) * ctx.slots)),
          "keygen_s": keygen_s, "first_calls_s": first_s, "ms": ms,
          "slowdown": {k: ms["mesh"][k] / ms["single"][k] for k in ms["mesh"]},
          "graphed": graphed, "ops": per_op,
          "equal_to_single_device": equal, "decode_diffs": diffs,
          "fallbacks": {"single": plans[eng].fallbacks, "mesh": plans[meng].fallbacks},
          "programs": sorted(str(k) for k in meng._mesh_jit),
          "captures": meng.ring.graphs.captures, "replays": meng.ring.graphs.replays,
          "launches": launches, "expected_launches": expected,
          "other_kernel_launches": foreign, "transfers_and_bytes": traffic,
          "elementwise_launches": {k: v for k, v in ew.items() if v},
          "operand_copies": ew_copies(),
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
          "memory_reserved_mb": torch.cuda.memory_reserved() / 2**20})
    if not all(equal.values()):
        raise AssertionError(f"mesh logp={logp}: differs from the single-device engine: {equal}")
    bad = {k: d for k, d in diffs.items() if not d < 1e-5}
    if bad:
        raise AssertionError(f"mesh logp={logp}: decode diffs {bad} >= 1e-5")
    if plans[eng].fallbacks or plans[meng].fallbacks or not meng._mesh_jit:
        raise AssertionError(f"mesh logp={logp}: gemv fell back, or no sharded program was built")
    if mesh.graphable and not all(graphed.values()):
        raise AssertionError(f"mesh logp={logp}: a one-device mesh left programs eager: {graphed}")
    if launches != expected or any(foreign.values()):
        raise AssertionError(f"mesh logp={logp}: NTT launches {launches}, expected {expected}; "
                             f"other kernel {foreign}")
    require_ew_launches(f"mesh logp={logp}", ew)
    mesh_poly_mul(logp, ctx, eng, devices, iters)
    return {"launches": launches, "elementwise": ew}


def mesh_poly_mul(logp: int, ctx, eng, devices, iters: int) -> None:
    """build_sharded_poly_mul_3d on the (2,2,2) mesh at the ring of ctx: B=2
    pairs of random polynomials below q_L, over the product basis padded
    to the limb axis, against the single-device RingEngine.poly_mul on each
    pair; graphed (a first call and a replay on another pair) against
    graphs.disabled(); its chain's NTT launched in a counted call.  Walls
    in turns beside the single device's two poly_muls."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.parallel import mesh as pm
    from gpqhe_tpu_torch.scheme.types import limbs_to_torch
    from gpqhe_tpu_torch.utils import graphs

    mesh = pm.make_he_mesh3(8, limb=2, coeff=2, devices=devices)
    L, B, n = ctx.L, mesh.size("batch"), ctx.poly.n
    dim, K, qb = pm._pad_dim(ctx.dim_mul(L), 2, ctx.poly.dimub), eng.kl(L), eng.qbits(L)
    rng = np.random.default_rng(693)

    def pair():
        words = rng.integers(0, 1 << 32, (2, B, n, K), dtype=np.uint32)
        words[..., -1] &= np.uint32((1 << (qb - 32 * (K - 1))) - 1)
        return tuple(limbs_to_torch(w, eng.device) for w in words)
    inputs = [pair(), pair()]
    f = pm.build_sharded_poly_mul_3d(ctx.poly, dim, K, qb, K, mesh)
    got = [f(*x) for x in inputs]                    # capture, then a replay
    with graphs.disabled():
        eager_out = [f(*x) for x in inputs]
    single = [torch.stack([eng.ring.poly_mul(a[i], b[i], dim, qb, K) for i in range(B)])
              for a, b in inputs]
    mine, other = chain_counters(logp)
    f(*inputs[0])
    torch.cuda.synchronize()
    launches, foreign = dict(mine), dict(other)
    few = max(3, iters // 4)

    def call():
        return f(*inputs[0])
    w = [cuda_ms(eager(call), few), cuda_ms(call, few), cuda_ms(call, few),
         cuda_ms(eager(call), few)]
    ok = {"graphed_equal_eager": all(torch.equal(g, e) for g, e in zip(got, eager_out)),
          "equal_to_single_device": all(torch.equal(g, s) for g, s in zip(got, single))}
    emit({"phase": "mesh_poly_mul", "logp": logp, "logn": ctx.poly.logn, "mesh": dict(mesh.shape),
          "shape": [B, n, K], "dim": dim, "mask_bits": qb,
          "graphed": isinstance(f, graphs.Program) and len(f.graphs) == 1, **ok,
          "wall_ms_eager": [w[0], w[3]], "wall_ms_graphed": w[1:3],
          "single_ms": cuda_ms(lambda: [eng.ring.poly_mul(inputs[0][0][i], inputs[0][1][i], dim,
                                                          qb, K) for i in range(B)], few),
          "launches": launches, "other_kernel_launches": foreign})
    if not all(ok.values()) or (mesh.graphable and not isinstance(f, graphs.Program)):
        raise AssertionError(f"mesh poly_mul_3d logp={logp}: {ok}")
    require_launches(f"mesh poly_mul_3d logp={logp}", {m: launches[m] for m in ("fwd", "inv")},
                     foreign)


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
    from gpqhe_tpu_torch.utils import graphs

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
    progs = list(meng._mesh_jit.values())
    graphed = any(isinstance(p, graphs.Program) for p in progs)
    emit({"phase": "mesh_mixed", "logp": logp, "logn": 9, "logq": 120, "slots": 4,
          "logDelta": 30, "mesh": dict(mesh.shape),
          "devices": [str(mesh.device(p)) for p in mesh.positions],
          "graphed": graphed, "eager_why": mesh.eager_why,
          "equal_to_single_device": equal, "first_difference": differ,
          "device_copy_bytes": copies, "views_in_psum_and_ppermute": views_due_copies,
          "traffic": traffic, "seconds": time.time() - t0})
    if not all(equal.values()):
        raise AssertionError(f"mixed mesh logp={logp}: differs from the card: {differ}")
    if not all(copies.values()) or any(views_due_copies.values()):
        raise AssertionError(f"mixed mesh logp={logp}: copies {copies}, views where a copy "
                             f"was due {views_due_copies}")
    if graphed or mesh.graphable or not progs:
        raise AssertionError(f"mixed mesh logp={logp}: a mesh of the card and the host "
                             f"graphed its programs ({[type(p) for p in progs]})")


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
                "graphed": ln.get("graphed"), "eager_why": ln.get("eager_why"),
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
                if r["graphed"] is not False:
                    problems.append(f"{where}: a mesh across processes graphed ({r['graphed']})")
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
    kernels, launches, ew = {}, {}, {}
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
        launches.update({f"{kernel}_{mode}": got["launches"][mode] for mode in r})
        for k, v in got["elementwise"].items():
            ew[k] = ew.get(k, 0) + v
        mesh_mixed(logp)
    mesh_cli()
    return {"kernels": kernels, "launches": launches, "elementwise": ew}


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
    from gpqhe_tpu_torch.utils import graphs

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
    reserved0 = torch.cuda.memory_reserved()
    (m0, m1), first_s = run(meng, bctx_m)                 # builds tables, programs, graphs
    launches, foreign = dict(mine), dict(other)
    reserved = torch.cuda.memory_reserved()
    with graphs.disabled():
        (e0, e1), _ = run(meng, bctx_m)
    equal = {"single": all(torch.equal(a, b) for a, b in (
                 (s0.c0, m0.c0), (s0.c1, m0.c1), (s1.c0, m1.c0), (s1.c1, m1.c1))),
             "eager": all(torch.equal(a, b) for a, b in (
                 (e0.c0, m0.c0), (e0.c1, m0.c1), (e1.c0, m1.c0), (e1.c1, m1.c1)))}
    mesh.reset_traffic()
    _, mesh_s = run(meng, bctx_m)
    traffic = {kind: list(c) for kind, c in mesh.traffic.items()}
    mesh.reset_traffic()
    with graphs.disabled():
        run(meng, bctx_m)
    traffic_eager = {kind: list(c) for kind, c in mesh.traffic.items()}
    _, single_s = run(eng, bctx_s)

    def graphed():
        return run(meng, bctx_m)[1]
    few = max(2, iters // 5)
    walls = [median([eager(graphed)() for _ in range(few)]),
             median([graphed() for _ in range(few)]), median([graphed() for _ in range(few)]),
             median([eager(graphed)() for _ in range(few)])]
    prof = {mode: profile_op("coeff2slot", f, host_ops=False, warm=False, mesh=[2, 4, 1],
                             mode=mode)
            for mode, f in (("graphed", lambda: bs.coeff2slot(meng, bctx_m, ct, ck, rk)),
                            ("eager", eager(lambda: bs.coeff2slot(meng, bctx_m, ct, ck, rk))))}
    progs = list(meng._mesh_jit.values())
    emit({"phase": "mesh_compose", "logn": 15, "logq": LOGQ[15], "slots": 4, "logDelta": 30,
          "mesh": dict(mesh.shape), "devices": what, "level": l,
          "graphable": mesh.graphable, "eager_why": mesh.eager_why,
          "graphed_programs": sum(isinstance(p, graphs.Program) for p in progs),
          "graphs": sum(len(getattr(p, "graphs", ())) for p in progs),
          "equal_to_single_device": equal["single"], "graphed_equal_eager": equal["eager"],
          "first_call_s": first_s, "mesh_s": mesh_s,
          "single_s": single_s, "slowdown": mesh_s / single_s,
          "wall_s_eager": [walls[0], walls[3]], "wall_s_graphed": walls[1:3],
          "busy_ms": {m: p.get("device_busy_ms") for m, p in prof.items()},
          "device_ops": {m: p.get("device_kernels") for m, p in prof.items()},
          "programs": sorted(str(k) for k in meng._mesh_jit),
          "fallbacks": {name: plan.fallbacks for name, plan in bctx_m._plans.items()},
          "launches_first_call": launches, "other_kernel_launches": foreign,
          "transfers_and_bytes": traffic, "transfers_and_bytes_eager": traffic_eager,
          "memory_reserved_mb": reserved / 2**20,
          "memory_reserved_mb_before_first_call": reserved0 / 2**20,
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    if not all(equal.values()):
        raise AssertionError(f"coeff2slot on the mesh differs: {equal}")
    if not meng._mesh_jit or launches["fwd"] <= 0 or launches["inv"] <= 0 or any(foreign.values()):
        raise AssertionError(f"coeff2slot on the mesh: programs {list(meng._mesh_jit)}, "
                             f"NTT launches {launches}, other kernel {foreign}")
    if traffic != traffic_eager or (mesh.graphable and not all(
            isinstance(p, graphs.Program) and p.graphs for p in progs)):
        raise AssertionError(f"coeff2slot on the mesh: traffic graphed {traffic}, eager "
                             f"{traffic_eager}; programs {[type(p) for p in progs]}")
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
    ew_reset()
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
    launches, foreign, ew = dict(mine), dict(other), ew_counters()
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
          "elementwise_launches": {k: v for k, v in ew.items() if v},
          "operand_copies": ew_copies(),
          "graphs": {"captures": eng.ring.graphs.captures, "replays": eng.ring.graphs.replays},
          "memory_reserved_mb": torch.cuda.memory_reserved() / 2**20,
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
    require_ew_launches("bootstrap", ew)
    if any(k.startswith("modmath_") and " " in k for k in ew):       # counted by shape class
        gone = [c for c in BOOT15_K5 if ew.get(boot15_key(*c), 0) <= 0]
        if gone:
            raise AssertionError(f"the bootstrap no longer launches K5 at the kernels15 shapes "
                                 f"{gone}: update BOOT15_K5")
    return {"kernels": kernels, "launches": launches, "elementwise": ew,
            "objects": dict(ctx=ctx, eng=eng, pk=pk, sk=sk, rlk=rlk, ck=ck, rk=rk, ct=ct_top,
                            boot=boot, bctx=bctx)}


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


# ---------------------------------------------------------------------------
# the graphs phase: each engine program as a CUDA graph (utils/graphs.py)
# against the same program run eagerly under graphs.disabled()
# ---------------------------------------------------------------------------

GRAPH_RING = dict(logn=14, q=1 << 438, slots=16, Delta=1 << 50)    # the main path's ring
GRAPH_BATCH = 8
GRAPH_INPUTS = 3        # fresh input sets each graphed op is held to disabled() on
GRAPH_ENGINES = ((59, "butterfly"), (29, "butterfly"), (59, "matmul"))
# the path's ops, then the programs of at most three launches (the add
# family, rs, moddown, a galois map) and dec
GRAPH_OPS = ("mul_rs", "rot", "conj", "mulpt", "mul_rs_batch8", "gemv_full", "gemv_bsgs",
             "add", "sub", "neg", "rs", "moddown", "galois", "dec")
HOISTED = ("gemv_full", "gemv_bsgs")


def graph_case(logp: int, impl: str = "butterfly", device=None, ring: dict = GRAPH_RING) -> dict:
    """An engine at the ring on the logp-bit chain and NTT backend impl
    (device None: the card), its keys (pk, sk, rlk, ck, a rotation key by
    every slot), a maker of fresh inputs (`fresh(seed)`: ciphertexts from
    numpy-seeded messages, a plaintext, two batches of GRAPH_BATCH) and the
    ops of GRAPH_OPS on them (the hoisted gemv, fully hoisted and BSGS, on
    the butterfly backend only: the four-step one falls back)."""
    import numpy as np
    from gpqhe_tpu_torch.algo import linalg
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    ctx = HeContext(**ring, logp=logp)
    eng = CKKS(ctx, rng=Surf(), device=device, ntt_impl=impl)
    pk, sk = eng.keypair()
    rlk, ck, rk = eng.genrlk(sk), eng.genck(sk), eng.genrk(sk)
    slots = ctx.slots
    rng0 = np.random.default_rng(logp)
    plan = linalg.HoistedGemvPlan(
        eng, rng0.random(slots * slots) + 1j * rng0.random(slots * slots))
    bank = {r: rk[r] for r in rk if r < plan.n1 or r % plan.n1 == 0}

    def fresh(seed: int) -> dict:
        rng = np.random.default_rng(seed)

        def msg():
            return rng.random(slots) + 1j * rng.random(slots)

        def ct():
            return eng.enc_pk(eng.ecd(msg()), pk)
        return {"ct1": ct(), "ct2": ct(), "pt": eng.ecd(msg()),
                "cts1": [ct() for _ in range(GRAPH_BATCH)],
                "cts2": [ct() for _ in range(GRAPH_BATCH)]}

    qb = eng.qbits(ctx.L)
    ops = {
        "mul_rs": lambda x: eng.mul_rs(x["ct1"], x["ct2"], rlk),
        "rot": lambda x: eng.rot(x["ct1"], 1, rk),
        "conj": lambda x: eng.conj(x["ct1"], ck),
        "mulpt": lambda x: eng.mulpt(x["ct1"], x["pt"]),
        "mul_rs_batch8": lambda x: eng.mul_rs_batch(x["cts1"], x["cts2"], rlk),
        "gemv_full": lambda x: linalg.gemv_hoisted(eng, plan, x["ct1"], rk),
        "gemv_bsgs": lambda x: linalg.gemv_hoisted(eng, plan, x["ct1"], bank),
        "add": lambda x: eng.add(x["ct1"], x["ct2"]),
        "sub": lambda x: eng.sub(x["ct1"], x["ct2"]),
        "neg": lambda x: eng.neg(x["ct1"]),
        "rs": lambda x: eng.rs(x["ct2"]),
        "moddown": lambda x: eng.moddown(x["ct2"]),
        "galois": lambda x: eng.ring.galois(x["ct1"].c0, 1, qb),
        "dec": lambda x: eng.dec(x["ct1"], sk),
    }
    if impl == "matmul":
        ops = {k: v for k, v in ops.items() if k not in HOISTED}
    return {"eng": eng, "ctx": ctx, "keys": (pk, sk, rlk, ck, rk), "fresh": fresh, "ops": ops,
            "plan": plan}


def graph_tensors(x) -> list:
    """The tensors of an op's result (a ciphertext, a plaintext, a tensor
    or a list of them), with a ciphertext's (l, nu, B) as a tuple."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in graph_tensors(y)]
    if hasattr(x, "c0"):
        return [x.c0, x.c1, (x.l, x.nu, x.B)]
    return [x.m, (x.nu, x.mod_bits)]


def graph_same(a, b) -> bool:
    import torch
    ta, tb = graph_tensors(a), graph_tensors(b)
    return len(ta) == len(tb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(ta, tb))


def launch_counters_delta(before: list) -> dict:
    """The launch counters' gain since `before` (graphs.counters_snapshot),
    by kernel binding; the wrappers' operand copies (cuda_build.COPIES) left
    out, as a caller's strides may differ from a graph's static buffers, and
    the meshes' traffic (read from the mesh: mesh_replays_match)."""
    from gpqhe_tpu_torch.ops import cuda_build
    from gpqhe_tpu_torch.parallel.mesh import TRAFFIC
    from gpqhe_tpu_torch.utils import graphs
    return {i: d for i, (c, d) in enumerate(zip(cuda_build.COUNTERS,
                                                graphs.counters_delta(before)))
            if d and c is not cuda_build.COPIES and c is not TRAFFIC}


def graph_check(fn, inputs: list, name: str) -> dict:
    """fn graphed against fn under graphs.disabled() on every input set: the
    first calls (warm-up and capture) and then replays, each torch.equal to
    the eager result; the first call's result unchanged after all the
    later calls; no two calls' results sharing memory; and the launch
    counters after one graphed call (a replay) equal to one eager call's.
    Raises on any difference.  Returns the first call's ms (graphed, with
    its captures) and the launches of one call."""
    import torch
    from gpqhe_tpu_torch.utils import graphs

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    got = [fn(inputs[0])]
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    held = [t.clone() for t in graph_tensors(got[0]) if isinstance(t, torch.Tensor)]
    got += [fn(x) for x in inputs[1:]] + [fn(x) for x in inputs]
    with graphs.disabled():
        want = [fn(x) for x in inputs]
    bad = [i for i, g in enumerate(got) if not graph_same(g, want[i % len(inputs)])]
    if bad:
        raise AssertionError(f"graphs {name}: calls {bad} differ from the eager program")
    now = [t for t in graph_tensors(got[0]) if isinstance(t, torch.Tensor)]
    if not all(torch.equal(a, b) for a, b in zip(held, now)):
        raise AssertionError(f"graphs {name}: a later replay overwrote the first result")
    seen = {}
    for i, g in enumerate(got):
        for t in graph_tensors(g):
            if isinstance(t, torch.Tensor):
                owner = seen.setdefault(t.untyped_storage().data_ptr(), i)
                if owner != i:
                    raise AssertionError(f"graphs {name}: calls {owner} and {i} share memory")
    before = graphs.counters_snapshot()
    fn(inputs[0])
    graphed = launch_counters_delta(before)
    before = graphs.counters_snapshot()
    with graphs.disabled():
        fn(inputs[0])
    eager = launch_counters_delta(before)
    if graphed != eager:
        raise AssertionError(f"graphs {name}: launch counters of a replay {graphed} against "
                             f"an eager call's {eager}")
    return {"first_ms": first_ms, "launches": sum(v for d in eager.values() for v in d.values())}


def eager(fn):
    """fn run eagerly, every program under graphs.disabled()."""
    from gpqhe_tpu_torch.utils import graphs

    def run():
        with graphs.disabled():
            return fn()
    return run


def phase_graphs(iters: int, boot: dict | None) -> None:
    """Every engine program as a CUDA graph against the same program under
    graphs.disabled(), at the main path's ring on both chains and on the
    four-step backend (graph_check on GRAPH_INPUTS fresh input sets, the
    launch counters equal), then the logn=15 bootstrap graphed against
    eager on two inputs.  Per op: first-call ms (its captures), walls in
    turns (eager, graphed, graphed, eager), host µs a call both ways, and a
    profile of each (busy ms, kernels, idle share, host dispatches: graph
    launches, copies, kernel launches).  Gate: a graphed mul_rs on the
    59-bit chain dispatches one graph and at most 8 copies."""
    import torch

    few = max(3, iters // 4)
    for logp, impl in GRAPH_ENGINES:
        t0 = time.time()
        case = graph_case(logp, impl)
        inputs = [case["fresh"](seed) for seed in range(GRAPH_INPUTS)]
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        g = case["eng"].ring.graphs
        out = {}
        for op, fn in case["ops"].items():
            r = graph_check(fn, inputs, f"{op} logp={logp} {impl}")
            x = inputs[0]

            def call(fn=fn):
                return fn(x)
            walls = [cuda_ms(eager(call), few), cuda_ms(call, few), cuda_ms(call, few),
                     cuda_ms(eager(call), few)]
            r.update({"wall_ms_eager": [walls[0], walls[3]], "wall_ms_graphed": walls[1:3],
                      "host_us_eager": host_us(eager(call), 50),
                      "host_us_graphed": host_us(call, 50)})
            out[op] = r
            for mode, f in (("graphed", call), ("eager", eager(call))):
                prof = profile_op(op, f, logp=logp, impl=impl, mode=mode)
                if (op, logp, impl, mode) == ("mul_rs", 59, "butterfly", "graphed"):
                    host = (prof or {}).get("host_dispatches")
                    if host and sum(host.values()) and (
                            host["graph_launches"] != 1
                            or host["copies"] + host["kernel_launches"] > 8):
                        raise AssertionError(f"graphs: a graphed mul_rs dispatched {host}")
        emit({"phase": "graphs", "logp": logp, "impl": impl, "setup_s": setup_s,
              "captures": g.captures, "replays": g.replays, "ops": out,
              "memory_reserved_mb": torch.cuda.memory_reserved() / 2**20})
        case = inputs = None
    graph_bootstrap(iters, boot)


def graph_bootstrap(iters: int, o: dict | None) -> None:
    """The logn=15 bootstrap graphed against eager, on the bootstrap phase's
    objects (or keys of its own): two inputs, each torch.equal; walls in
    turns; memory."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch import bootstrap as bs
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf
    from gpqhe_tpu_torch.utils import graphs

    if o is None:
        ctx = HeContext(logn=15, q=1 << LOGQ[15], slots=4, Delta=1 << 30)
        eng = CKKS(ctx, rng=Surf())
        pk, sk = eng.keypair()
        o = dict(ctx=ctx, eng=eng, sk=sk, rlk=eng.genrlk(sk), ck=eng.genck(sk),
                 rk=eng.genrk(sk, bs.bootstrap_rotations(ctx)), bctx=bs.BootstrapContext(eng),
                 pk=pk)
    eng, ctx = o["eng"], o["ctx"]
    rng = np.random.default_rng(15)
    cts = []
    for _ in range(2):
        ct = eng.enc_pk(eng.ecd(0.1 * (rng.random(ctx.slots) + 1j * rng.random(ctx.slots))),
                        o["pk"])
        while ct.l > 1:
            ct = eng.moddown(ct)
        cts.append(ct)

    def run(ct):
        return bs.bootstrap(eng, o["bctx"], ct, o["rlk"], o["ck"], o["rk"])
    g = eng.ring.graphs
    captures0 = g.captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [run(c) for c in cts]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got += [run(c) for c in cts]
    torch.cuda.reset_peak_memory_stats()
    reserved_graphed = torch.cuda.memory_reserved()
    with graphs.disabled():
        want = [run(c) for c in cts]
    peak_eager = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run(cts[0])
    peak_graphed = torch.cuda.max_memory_allocated()
    bad = [i for i, r in enumerate(got) if not graph_same(r, want[i % 2])]
    few = max(1, iters // 5)
    walls = [wall_s(eager(lambda: run(cts[0])), few), wall_s(lambda: run(cts[0]), few),
             wall_s(lambda: run(cts[0]), few), wall_s(eager(lambda: run(cts[0])), few)]
    profile_op("bootstrap", lambda: run(cts[0]), host_ops=False, mode="graphed")
    profile_op("bootstrap", eager(lambda: run(cts[0])), host_ops=False, mode="eager")
    emit({"phase": "graphs", "bootstrap": True, "logn": ctx.poly.logn, "equal": not bad,
          "first_two_calls_s": first_s, "captures_before": captures0,
          "captures": g.captures, "replays": g.replays,
          "wall_s_eager": [walls[0], walls[3]], "wall_s_graphed": walls[1:3],
          "memory_reserved_mb": reserved_graphed / 2**20,
          "memory_allocated_mb": torch.cuda.memory_allocated() / 2**20,
          "peak_allocated_mb_eager_call": peak_eager / 2**20,
          "peak_allocated_mb_graphed_call": peak_graphed / 2**20})
    if bad:
        raise AssertionError(f"graphs bootstrap: calls {bad} differ from the eager program")


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


# ---------------------------------------------------------------------------
# K8 (csrc/ntt4.cu): the four-step ("matmul") NTT's stage, one launch of a
# u8 tensor-core product a stage, and the engine on that backend
# ---------------------------------------------------------------------------

KERNELS["ntt4"] = {"source": "gpqhe_tpu_torch/csrc/ntt4.cu",
                   "replaces": "gpqhe_tpu/ops/ntt4.py:130"}
# the JAX code the entry stands in for: _moddot (digit planes, sums,
# carries, reduction) with the multiplies around it (pre-twist 182, twiddle
# 187 / 206, transpose 189 / 205, untwist 209, phat^-1 ring/poly.py:199)
NTT4_REPLACES = {"ntt4_stage": "gpqhe_tpu/ops/ntt4.py:130"}
# the main path's transforms at logn=14 by chain, (mode, leading axes and
# primes): the butterfly path's shapes, each timed
NTT4_PATH = {logp: [(mode, shape[:-1]) for mode, shape in CASES[k] if shape[-1] == N14]
             for logp, k in ((59, "ntt"), (29, "ntt32"))}
PEAK_INT8_S = 1979e12      # int8 on the tensor cores, dense (NVIDIA's data sheet), ops a second


def ntt4_edge_cases(max_logn: int = 16) -> list:
    """K8 at the edges of its design: every logn from 4 to max_logn on both
    chains (odd logn: n1 != n2, e.g. 15: 128 x 256; a contraction below
    the mma's depth of 32 and outputs past the block's tile below logn 12),
    a batch of 1 and of 8, words all 0, all p - 1 or random, each mode; the
    logp=9 chain (two byte planes) at its ring.  A case names the ring
    (context arguments), dim, the leading axes, the mode and the fill;
    ntt4_input makes its words."""
    cases = []
    for logp in (59, 29):
        for logn in range(4, max_logn + 1):
            for mode, lead, fill in (("fwd", (1,), "pmax"), ("fwd", (8,), "zero"),
                                     ("inv", (8,), "random"), ("inv_scaled", (1,), "pmax")):
                cases.append(dict(logp=logp, logn=logn, dim=3, lead=lead, mode=mode, fill=fill,
                                  ctx=dict(q=1 << 20, logp=logp, dim_cap=8)))
    for mode in MODES:
        for fill in ("pmax", "random"):
            cases.append(dict(logp=9, logn=4, dim=6, lead=(2,), mode=mode, fill=fill,
                              ctx=dict(CRT_CHAIN)))
    for c in cases:
        c["id"] = f"p{c['logp']}-n{c['logn']}-{c['mode']}-b{c['lead'][0]}-{c['fill']}"
    return cases


def ntt4_input(case, plan, device):
    """The case's [*lead, dim, n] residues on the device."""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.ops.modmath import torch_to_u64
    ps = torch_to_u64(plan.ps)[:, None]
    shape = tuple(case["lead"]) + (plan.dim, plan.n1 * plan.n2)
    if case["fill"] == "zero":
        x = np.zeros(shape, dtype=np.uint64)
    elif case["fill"] == "pmax":
        x = np.broadcast_to(ps - np.uint64(1), shape).copy()
    else:
        rng = np.random.default_rng(100 * case["logn"] + case["logp"])
        x = rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % ps
    return torch.from_numpy(x.view(np.int64)).to(device)


def ntt4_compare(x, plan, mode: str):
    """K8 against its plain version on one transform: each of its two stages
    run by the kernel and by the plain version (split, torch.bmm, combine)
    on the same inputs, the kernel's output handed on, then the whole kernel
    transform against the plain one.  Returns (every stage and the whole
    equal, [(entry, args, kernel output)], the transform)."""
    import torch
    from gpqhe_tpu_torch.ops import ntt4, ntt4_cuda
    steps, eq = [], []

    def stage(*a):
        got = ntt4_cuda.stage(*a)
        eq.append(bool(torch.equal(got, ntt4.plain_ntt4_stage(*a))))
        steps.append(("ntt4_stage", a, got))
        return got
    inverse = mode != "fwd"
    scale = plan.phatinv if mode == "inv_scaled" else None
    ntt4.transform(x, plan, inverse, scale, stage)
    if inverse:
        got = ntt4.kernel_intt4(x, plan, scale is not None)
        want = ntt4.plain_intt4(x, plan, scale is not None)
    else:
        got, want = ntt4.kernel_ntt4(x, plan), ntt4.plain_ntt4(x, plan)
    eq.append(bool(torch.equal(got, want)))
    return all(eq), steps, got


def ntt4_max_sums(plan, P8: int, device, K: int = 256, J: int = 32):
    """A stage at its largest anti-diagonal sums: a contraction of K = 256,
    every byte of W and of X 255 (words 2^(8 P8) - 1: P8 byte planes a
    side for the kernel, the same words' 16-bit planes for the plain
    version), B = 2, no pre-table, a post-table and phat^-1.  Returns the
    stage's arguments (x, plan, "w1", rows, cols, transpose, pre, post,
    scale) on the plan's primes."""
    import dataclasses
    import numpy as np
    import torch
    from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch
    dim, P = plan.dim, P8 // 2
    big = dataclasses.replace(
        plan, planes=P, planes8=P8,
        w1u8=torch.full((dim, P8, K, K), 255, dtype=torch.uint8, device=device),
        w1dig=torch.full((dim, P * K, K), 65535.0, dtype=torch.float64, device=device))
    word = np.uint64((1 << 8 * P8) - 1)
    x = u64_to_torch(np.full((2, dim, K * J), word, dtype=np.uint64), device)
    rng = np.random.default_rng(P8)
    ps = torch_to_u64(plan.ps)[:, None]
    post = u64_to_torch(rng.integers(0, 1 << 62, size=(dim, K * J), dtype=np.uint64) % ps,
                        device)
    return (x, big, "w1", K, J, False, None, post, plan.phatinv)


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


NTT4_RING = dict(logn=14, q=1 << 438, slots=16, Delta=1 << 50)      # configuration (a)


def ntt4_path(logp: int, iters: int, ring: dict = NTT4_RING, device=None) -> dict:
    """The slice's path on the four-step backend at the ring (logn=14/
    logq=438/slots=16/Delta=2^50) on the logp-bit chain, the engine built
    with no device argument (device: the CPU rehearsal's) and
    ntt_impl="matmul": keypair, genrlk, genck, genrk (16
    keys), ecd + enc_pk, mul_rs, rot, conj, mulpt, mul_rs_batch (8), the
    classic gemv, gemv_hoisted (which falls back to it here, as in JAX),
    dec, dcd; first the same sequence on a butterfly engine from the same
    Surf stream.  Gates: decodes within 1e-5; every ciphertext torch.equal
    to the butterfly engine's (gemv_hoisted to its classic gemv);
    plan.fallbacks == 1; over the matmul
    engine's run (counters zeroed just before it, read just after) K8's
    launches > 0, every elementwise kernel's > 0, K1-K3's 0.  Then walls,
    keygen seconds and profiles of mul_rs and rot on both engines."""
    import warnings

    import numpy as np
    import torch
    from gpqhe_tpu_torch.algo import linalg
    from gpqhe_tpu_torch.context import HeContext
    from gpqhe_tpu_torch.ops import ntt4_cuda
    from gpqhe_tpu_torch.ring import sample as smp
    from gpqhe_tpu_torch.scheme.engine import CKKS
    from gpqhe_tpu_torch.substrate.surf import Surf

    BATCH = 8
    ctx = HeContext(**ring, logp=logp)
    slots = ctx.slots

    def run(impl: str) -> dict:
        t0 = time.time()
        eng = CKKS(ctx, rng=Surf(), device=device, ntt_impl=impl)   # None: the card
        if device is None and eng.device.type != "cuda":
            raise AssertionError(f"CKKS(ctx, ntt_impl={impl!r}) chose {eng.device}")
        pk, sk = eng.keypair()
        rlk, ck, rk = eng.genrlk(sk), eng.genck(sk), eng.genrk(sk)
        torch.cuda.synchronize()
        keygen_s = time.time() - t0
        v, m2 = smp.sample_z01vec(eng.rng, slots), smp.sample_z01vec(eng.rng, slots)
        A = smp.sample_z01vec(eng.rng, slots * slots)
        rng = np.random.default_rng(438)
        ms = rng.random((BATCH, 2, slots)) + 1j * rng.random((BATCH, 2, slots))
        ct, ct2 = eng.enc_pk(eng.ecd(v), pk), eng.enc_pk(eng.ecd(m2), pk)
        cts1 = [eng.enc_pk(eng.ecd(m[0]), pk) for m in ms]
        cts2 = [eng.enc_pk(eng.ecd(m[1]), pk) for m in ms]
        plan = linalg.HoistedGemvPlan(eng, A)
        Av = A.reshape(slots, slots) @ v
        out = {"mul_rs": (eng.mul_rs(ct, ct2, rlk), v * m2),
               "rot": (eng.rot(ct, 1, rk), np.roll(v, -1)),
               "conj": (eng.conj(ct, ck), np.conj(v)),
               "mulpt": (eng.rs(eng.mulpt(ct, eng.ecd(m2))), v * m2),
               "gemv_classic": (linalg.gemv(eng, None, ct, rk, plan=plan), Av)}
        for i, c in enumerate(eng.mul_rs_batch(cts1, cts2, rlk)):
            out[f"batch{i}"] = (c, ms[i, 0] * ms[i, 1])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["gemv_hoisted"] = (linalg.gemv_hoisted(eng, plan, ct, rk), Av)
        diffs = {k: float(np.max(np.abs(eng.dcd(eng.dec(c, sk)) - want)))
                 for k, (c, want) in out.items()}
        torch.cuda.synchronize()
        return {"eng": eng, "cts": {k: c for k, (c, _) in out.items()}, "diffs": diffs,
                "fallbacks": plan.fallbacks, "keygen_s": keygen_s,
                "warned": sum("falling back" in str(w.message) for w in caught),
                "ops": {"mul_rs": lambda: eng.mul_rs(ct, ct2, rlk),
                        "rot": lambda: eng.rot(ct, 1, rk)}}

    ref = run("butterfly")
    mine, other = chain_counters(logp)
    ntt4_cuda.reset_launches()
    ew_reset()
    got = run("matmul")
    k8, ew = {f"ntt4_{k}": v for k, v in ntt4_cuda.LAUNCHES.items()}, ew_counters()
    butterfly_launches = {**dict(mine), **{f"other_{k}": v for k, v in other.items()}}

    # the matmul engine's gemv_hoisted is the classic gemv (the butterfly
    # engine's hoists: another algorithm, another ciphertext)
    same = {k: ref["cts"]["gemv_classic" if k == "gemv_hoisted" else k] for k in got["cts"]}
    unequal = {k: equal_cts(c, same[k]) for k, c in got["cts"].items()
               if not (torch.equal(c.c0, same[k].c0) and torch.equal(c.c1, same[k].c1)
                       and (c.l, c.nu, c.B) == (same[k].l, same[k].nu, same[k].B))}
    few = max(3, iters // 4)
    walls = {f"{op}_ms": {impl: cuda_ms(r["ops"][op], few) for impl, r in
                          (("butterfly", ref), ("matmul", got))} for op in ("mul_rs", "rot")}
    emit({"phase": "ntt4", "path": True, "logp": logp, "logn": ctx.poly.logn,
          "logq": ctx.q[ctx.L].bit_length() - 1, "slots": slots,
          "logDelta": int(ctx.Delta).bit_length() - 1, "L": ctx.L, "decode_diffs": got["diffs"],
          "butterfly_decode_diffs": ref["diffs"], "fallbacks": got["fallbacks"],
          "fallback_warnings": got["warned"], "ciphertexts_equal_butterfly": not unequal,
          "unequal": unequal, "keygen_s": {"butterfly": ref["keygen_s"], "matmul": got["keygen_s"]},
          **walls, "launches": k8, "butterfly_ntt_launches": butterfly_launches,
          "elementwise_launches": {k: v for k, v in ew.items() if v},
          "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20})
    bad = {k: d for k, d in got["diffs"].items() if not d < 1e-5}
    if bad:
        raise AssertionError(f"ntt4 path logp={logp}: decode diffs {bad} >= 1e-5")
    if unequal:
        raise AssertionError(f"ntt4 path logp={logp}: ciphertexts differ from the butterfly "
                             f"engine's: {unequal}")
    if got["fallbacks"] != 1 or ref["fallbacks"] != 0:
        raise AssertionError(f"ntt4 path logp={logp}: gemv_hoisted fallbacks "
                             f"{got['fallbacks']} (matmul), {ref['fallbacks']} (butterfly)")
    if any(v <= 0 for v in k8.values()) or any(butterfly_launches.values()):
        raise AssertionError(f"ntt4 path logp={logp}: K8 launches {k8}, "
                             f"butterfly NTT launches {butterfly_launches}")
    require_ew_launches(f"ntt4 path logp={logp}", ew)
    for op in ("mul_rs", "rot"):
        for impl, r in (("butterfly", ref), ("matmul", got)):
            profile_op(op, r["ops"][op], impl=impl, logp=logp)
    return {"launches": k8, "elementwise": ew}


def phase_ntt4(iters: int) -> dict:
    """K8 against its plain version at the path's shapes on both chains (each
    stage and the whole transform torch.equal, the round trip), each shape
    timed (ntt4_time); then at its edges
    (ntt4_edge_cases, every logn 4-16) and at a stage's largest digit sums
    for P8 = 2, 4, 8 (ntt4_max_sums); then the slice's path on both chains
    (ntt4_path).  Returns K8's kernel-line entry (the 59-bit chain's forward
    [4, 16, 2^14]: its first stage), its launches over the paths, and the
    elementwise launches."""
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
    launches, ew_total = {}, {}
    for logp in (59, 29):
        r = ntt4_path(logp, iters)
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in r["elementwise"].items():
            ew_total[k] = ew_total.get(k, 0) + v
    return {"kernels": result, "launches": launches, "elementwise": ew_total}


PHASES = ("build", "kernels", "golden", "mul_rs", "linalg59", "linalg29", "ntt4", "suite",
          "mesh", "mesh_mp", "nonlinear", "cmp", "bootstrap", "serialize", "graphs",
          "mesh_compose", "cli")


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
    ew_launches = {}            # the elementwise entries' launches over the gated paths
    ew_by_logn = {}             # the same by the ring's logn: the shape class of a launch

    def add_ew(counts: dict, logn: int = 14) -> None:
        for k, v in counts.items():
            ew_launches[k] = ew_launches.get(k, 0) + v
            by = ew_by_logn.setdefault(k, {})
            by[str(logn)] = by.get(str(logn), 0) + v
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernels = phase_kernels(args.iters)
        kernels.update(phase_elementwise(args.iters))
        clock("kernels")
    if "golden" in phases:
        phase_golden()
    if "mul_rs" in phases:
        add_ew(phase_mul_rs(max(3, args.iters // 4))["elementwise"])
        clock("mul_rs")
    chains = {}
    for name, logp, kernel in (("linalg59", 59, "ntt"), ("linalg29", 29, "ntt32")):
        if name in phases:
            r = chains[logp] = phase_linalg(name, logp, args.iters, chains.get(59))
            add_ew(r["elementwise"])
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
    if "ntt4" in phases:
        r = phase_ntt4(args.iters)
        add_ew(r["elementwise"])
        kernels.update(r["kernels"])
        launches.update(r["launches"])
        clock("ntt4")
    if "suite" in phases:
        r = phase_suite(args.iters, chains.get(59))
        kernels.update(r["kernels"])
        launches.update(r["launches"])
        clock("suite")
    chains = None

    if "mesh" in phases:
        r = phase_mesh(args.iters)
        add_ew(r["elementwise"])
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
        add_ew(boot["elementwise"], logn=15)
        kernels.update(boot["kernels"])
        launches.update({f"ntt15_{k}": v for k, v in boot["launches"].items()})
        if "serialize" in phases:
            phase_serialize(boot["objects"])
        clock("bootstrap and serialize")
    if "graphs" in phases:
        phase_graphs(args.iters, boot["objects"] if "bootstrap" in phases else None)
        clock("graphs")
    if "mesh" in phases or "mesh_compose" in phases:
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
    launches.update(ew_launches)
    if set(phases) != set(PHASES):
        emit({"ok": True, "partial": phases, "kernels": kernels, "launches": launches,
              "launches_by_logn": ew_by_logn})
        return 0
    # an elementwise entry that no gated path launched (to_mont, summod: the
    # port's programs call neither) has its numbers on the kernels lines
    # only; every NTT entry is listed and must have its count.  K5's entries
    # carry their launches by shape class and logn too
    table = {**KERNELS, **EW_KERNELS}

    def by_shape(name):
        out = {k[len(name) + 1:]: v for k, v in ew_by_logn.items() if k.startswith(name + " ")}
        return {"launches_by_shape": out} if out else {}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": table[name.split("_")[0]]["source"],
         "replaces": {**EW_REPLACES, **NTT4_REPLACES}.get(name,
                                                          table[name.split("_")[0]]["replaces"]),
         "launches": launches[name], "library_ms": None, **v,
         **({"launches_by_logn": ew_by_logn[name]} if name in ew_by_logn else {}),
         **by_shape(name)}
        for name, v in kernels.items()
        if name.split("_")[0] not in EW_KERNELS or launches.get(name, 0) > 0]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
