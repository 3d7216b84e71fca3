"""What torch.profiler sees of the fill and of a logn=15 bootstrap on the card:
fill kernels and pageable host-to-device copies, each capture the first of
its own process.

    python tests/torch_profile_copies.py fills|bootstrap15

prints one JSON line.  tests/test_torch_cuda.py runs it in a subprocess: a
capture that follows another one in the same process now and then comes
back without a pageable `Memcpy HtoD` that the counters saw (NVIDIA H100,
torch 2.11), so a test that counts them profiles first in a fresh process.
Jax-free; needs a CUDA device.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# (n, K, stride): the bootstrap ring's [2^15, 28] and the linear ring's
# [2^14, 14] at const_pt's stride n/2 and ecd's gap (slots 4 and 16), and an
# odd K (a word a thread)
FILLS = [(1 << 15, 28, 1 << 14), (1 << 15, 28, 1 << 12), (1 << 14, 14, 1 << 13),
         (1 << 14, 14, 1 << 9), (1 << 10, 5, 1 << 6)]


def profiled(fn, name: str):
    """(fn()'s result, the names of the device operations of a torch.profiler
    capture of it) from the first of four captures that shows a device
    operation whose name holds `name` (a capture now and then comes back
    without its device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if any(name in e for e in seen):
            return out, seen
    raise AssertionError(f"four profiler captures saw no {name}")


def counts(names) -> dict:
    return {"fill_kernels": sum("limbs_fill_kernel" in e for e in names),
            "memcpy_htod": sum(e.startswith("Memcpy HtoD") for e in names)}


def fills(dev) -> dict:
    """One capture of the five fills, after a call of each outside it (the
    library loaded); each fill torch.equal to plain_fill_rows."""
    from gpqhe_tpu_torch.ops import limbs
    cases = []
    for n, k, stride in FILLS:
        rows = np.random.default_rng(n + stride).integers(
            0, 1 << 32, size=(n // stride, k), dtype=np.uint64).astype(np.uint32)
        cases.append((rows, n, stride, limbs.plain_fill_rows(rows, n, stride, dev)))
        limbs.fill_rows(rows, n, stride, dev)
    torch.cuda.synchronize()
    outs, names = profiled(lambda: [limbs.fill_rows(r, n, s, dev) for r, n, s, _ in cases],
                           "limbs_fill_kernel")
    return {**counts(names), "equal": all(torch.equal(o, c[3]) for o, c in zip(outs, cases))}


def bootstrap15(dev) -> dict:
    """A logn=15 bootstrap from level 1, run once outside the capture (its
    programs captured, its plans' diagonals encoded): the counters of a
    second run, then one capture of a third."""
    from gpqhe_tpu_torch import CKKS, HeContext, Surf
    from gpqhe_tpu_torch import bootstrap as bs
    from gpqhe_tpu_torch.ops import limbs_cuda
    from gpqhe_tpu_torch.ring import sample
    from gpqhe_tpu_torch.utils import trace
    eng = CKKS(HeContext(15, 1 << 881, 4, 1 << 30), rng=Surf(), device=dev)
    pk, sk = eng.keypair()
    rlk, ck = eng.genrlk(sk), eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(eng.ctx))
    m0 = sample.sample_z01vec(eng.rng, eng.ctx.slots) * 0.1
    ct = eng.enc_pk(eng.ecd(m0), pk)
    while ct.l > 1:
        ct = eng.moddown(ct)
    bctx = bs.BootstrapContext(eng)
    bs.bootstrap(eng, bctx, ct, rlk, ck, rk)
    torch.cuda.synchronize()
    fill0, enc0, copies0 = limbs_cuda.LAUNCHES["fill_rows"], dict(trace.ENCODE), trace.H2D["copies"]
    boot = bs.bootstrap(eng, bctx, ct, rlk, ck, rk)
    torch.cuda.synchronize()
    out = {"fill_launches": limbs_cuda.LAUNCHES["fill_rows"] - fill0,
           "encode": {k: v - enc0[k] for k, v in trace.ENCODE.items()},
           "counted_copies": trace.H2D["copies"] - copies0, "level": boot.l,
           "decode_diff": float(np.max(np.abs(eng.dcd(eng.dec(boot, sk)) - m0)))}
    _, names = profiled(lambda: bs.bootstrap(eng, bctx, ct, rlk, ck, rk), "limbs_fill_kernel")
    return {**out, **counts(names)}


if __name__ == "__main__":
    device = torch.device("cuda")
    print(json.dumps({"fills": fills, "bootstrap15": bootstrap15}[sys.argv[1]](device)))
