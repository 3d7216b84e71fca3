"""Sharded mul_rs, rot(1), conj and the fully hoisted gemv on one
(limb, coeff, batch) mesh that spans several processes: the counterpart of
the JAX package's tools/mp_mul_rs.py.

For each chain (--logp), rank 0 makes the keys and ciphertexts from Surf(),
runs the four ops on the single-device engine and publishes all of it
through utils/serialize (one file an object, a rotation-key bank one file a
key, written and read by a pool of threads); the other ranks wait for its
marker.  The ranks form one torch.distributed group (a FileStore in a
temporary directory), build the global mesh of each --mesh layout over
every rank's local positions, run the four ops on MeshCKKS and hold c0, c1
and the metadata torch.equal to the published results, and each decode
within 1e-5 of the plaintext result.  Each rank prints one JSON line per
chain and layout (positions, equal flags, decode diffs, the collectives'
traffic by kind and the NTT launches of one call of each op; with --iters
also ms per op, the device busy ms of one mul_rs on a card, and on rank 0
the mul_rs ms of the same layout's one-process virtual mesh beside them).
The launcher relays the lines and prints PASS or FAIL last; it exits
non-zero when a rank fails, killing the others, or when a wait outlasts
--timeout.

  python -m gpqhe_tpu_torch.parallel.mp_mul_rs --device=cpu --backend=gloo
  python -m gpqhe_tpu_torch.parallel.mp_mul_rs --device=cuda --backend=gloo \\
      --logn=14 --logq=438 --slots=16 --logDelta=50 --logp=59,29 \\
      --mesh=2x2x2,1x4x2 --iters=3

--device=cuda puts rank r on card r mod the card count: on one card every
rank shares it, which an nccl group refuses, so there it takes gloo, whose
messages cross host memory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OPS = ("mul_rs", "rot", "conj", "gemv_full")
OBJECTS = ("sk", "rlk", "ck", "ct1", "ct2") + tuple(f"want_{op}" for op in OPS)
TOL = 1e-5          # decode diff against the plaintext result
GEMV_SEED = 16      # the gemv's matrix, np.random.default_rng(GEMV_SEED)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True,
                    help="torch.distributed backend (gloo stages CUDA blocks through host memory)")
    ap.add_argument("--logn", type=int, default=6)
    ap.add_argument("--logq", type=int, default=110)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--logDelta", type=int, default=30)
    ap.add_argument("--logp", default="59",
                    help="comma-separated chain prime bits (29: the u32 chain)")
    ap.add_argument("--mesh", default="2x2x2",
                    help="comma-separated layouts LxSxB (limb x coeff x batch)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="processes; each holds positions/ranks mesh positions")
    ap.add_argument("--iters", type=int, default=0,
                    help="timed runs per op (0: no timing)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds any wait may take")
    ap.add_argument("--out", default=None,
                    help="keep the published objects and every rank's results here")
    for hidden in ("--rank", "--dir", "--store"):      # set by the launcher for a rank
        ap.add_argument(hidden, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.logps = [int(v) for v in args.logp.split(",")]
    args.layouts = [tuple(int(v) for v in text.split("x")) for text in args.mesh.split(",")]
    for lay in args.layouts:
        if len(lay) != 3 or np.prod(lay) % args.ranks:
            raise SystemExit(f"mesh {lay}: three axes whose product divides by "
                             f"--ranks={args.ranks}")
    return args


def layout_name(layout) -> str:
    return "x".join(map(str, layout))


def hoist_bits(ctx, layouts) -> int:
    """The engine's default hoisting margin plus room for a gemv basis
    padded up to a multiple of the largest limb axis (one chain prime less
    than that axis at most): the keys are made once for every layout."""
    limb = max(lay[0] for lay in layouts)
    return int(ctx.Delta).bit_length() + ctx.poly.logn + 8 + (limb - 1) * ctx.logp_prime


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

def _log(rank, *a) -> None:
    print(f"[rank {rank}]", *a, file=sys.stderr, flush=True)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ops(eng, o, plan) -> dict:
    from ..algo import linalg
    return {"mul_rs": lambda: eng.mul_rs(o["ct1"], o["ct2"], o["rlk"]),
            "rot": lambda: eng.rot(o["ct1"], 1, o["rk"]),
            "conj": lambda: eng.conj(o["ct1"], o["ck"]),
            "gemv_full": lambda: linalg.gemv_hoisted_full(eng, plan, o["ct1"], o["rk"])}


def _same(a, b) -> bool:
    import torch
    return (a is not None and b is not None and (a.l, a.nu, a.B) == (b.l, b.nu, b.B)
            and torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1))


def _files(ctx) -> list[str]:
    """The published objects' names: OBJECTS and one rotation key a file
    (rk_r, r in range(slots): the bank genrk makes)."""
    return list(OBJECTS) + [f"rk_{r}" for r in range(ctx.slots)]


def _publish(chain_dir: str, ctx, dev, hb: int) -> dict:
    """Rank 0: keys, ciphertexts, messages and the single-device results.
    Returns the seconds of each part."""
    from ..algo import linalg
    from ..ring import sample as smp
    from ..scheme.engine import CKKS
    from ..substrate.surf import Surf
    from ..utils import serialize
    t0 = time.perf_counter()
    eng = CKKS(ctx, rng=Surf(), device=dev, hoist_bits=hb)
    pk, sk = eng.keypair()
    o = dict(sk=sk, rlk=eng.genrlk(sk), ck=eng.genck(sk), rk=eng.genrk(sk))
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    m2 = smp.sample_z01vec(eng.rng, ctx.slots)
    o["ct1"], o["ct2"] = eng.enc_pk(eng.ecd(m1), pk), eng.enc_pk(eng.ecd(m2), pk)
    rng = np.random.default_rng(GEMV_SEED)
    A = rng.random(ctx.slots ** 2) + 1j * rng.random(ctx.slots ** 2)
    plan = linalg.HoistedGemvPlan(eng, A)
    t1 = time.perf_counter()
    for op, fn in _ops(eng, o, plan).items():
        o[f"want_{op}"] = fn()
        if o[f"want_{op}"] is None:
            raise RuntimeError(f"the single-device {op} fell back (plan.fallbacks="
                               f"{plan.fallbacks})")
    _sync(dev)
    t2 = time.perf_counter()
    o.update({f"rk_{r}": swk for r, swk in o.pop("rk").items()})
    os.makedirs(chain_dir, exist_ok=True)
    with ThreadPoolExecutor(os.cpu_count()) as pool:      # zlib lets go of the GIL
        list(pool.map(lambda name: serialize.save(os.path.join(chain_dir, f"{name}.npz"),
                                                  ctx, o[name]), _files(ctx)))
    np.savez(os.path.join(chain_dir, "messages.npz"), m1=m1, m2=m2, A=A)
    with open(os.path.join(chain_dir, "ready"), "w") as fh:
        fh.write("ok")
    return {"keys_s": t1 - t0, "single_device_s": t2 - t1, "save_s": time.perf_counter() - t2}


def _load(chain_dir: str, ctx, dev) -> tuple[dict, dict]:
    """(the published objects on dev, the rotation keys as one bank "rk";
    the messages and the gemv's matrix)."""
    from ..utils import serialize
    names = _files(ctx)
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        got = list(pool.map(lambda name: serialize.load(
            os.path.join(chain_dir, f"{name}.npz"), ctx, device=dev), names))
    o = dict(zip(names, got))
    o["rk"] = {r: o.pop(f"rk_{r}") for r in range(ctx.slots)}
    with np.load(os.path.join(chain_dir, "messages.npz")) as z:
        return o, {k: z[k] for k in z.files}


def _wait_for(path: str, timeout: float) -> None:
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout} s")
        time.sleep(0.1)


def _busy_ms(fn, dev) -> float | None:
    """Device kernel milliseconds of one call of fn under torch.profiler
    (this process's kernels only); None on the CPU."""
    if dev.type != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 if kernels else None


def _median_ms(fn, dev, iters: int) -> float:
    times = []
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _mesh_ops(args, ctx, o, A, dev, hb: int, layout, group):
    """(the mesh of this layout, MeshCKKS over it, its four ops, the gemv
    plan); group None: every position in this process, on dev."""
    from ..algo import linalg
    from ..substrate.surf import Surf
    from .engine import MeshCKKS
    from .mesh import make_he_mesh3
    L, S, B = layout
    n = L * S * B
    local = n if group is None else n // args.ranks
    mesh = make_he_mesh3(n, limb=L, coeff=S, devices=[dev] * local, group=group)
    meng = MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=hb)
    plan = linalg.HoistedGemvPlan(meng, A)
    return mesh, meng, _ops(meng, o, plan), plan


def _first_calls(ops, o, dev):
    """The first call of each op (it builds the sharded programs): (results,
    equal to the published single-device ones, seconds)."""
    t0 = time.perf_counter()
    got = {op: fn() for op, fn in ops.items()}
    _sync(dev)
    return got, {op: _same(got[op], o[f"want_{op}"]) for op in OPS}, time.perf_counter() - t0


def _run_layout(args, ctx, o, msgs, dev, hb: int, layout, group, chain_dir: str) -> dict:
    """One layout across the ranks: first calls (checked), one counted call
    of each op, then the timing."""
    import torch
    from ..ops import ntt_cuda, ntt_cuda32
    from ..utils import graphs, serialize

    t0 = time.perf_counter()
    mesh, meng, ops, plan = _mesh_ops(args, ctx, o, msgs["A"], dev, hb, layout, group)
    got, equal, first_s = _first_calls(ops, o, dev)
    m1, m2 = msgs["m1"], msgs["m2"]
    expect = {"mul_rs": m1 * m2, "rot": np.roll(m1, -1), "conj": np.conj(m1),
              "gemv_full": msgs["A"].reshape(ctx.slots, ctx.slots) @ m1}
    diffs = {op: (float(np.max(np.abs(meng.dcd(meng.dec(got[op], o["sk"])) - expect[op])))
                  if got[op] is not None else None) for op in OPS}
    if args.out:
        for op in OPS:
            serialize.save(os.path.join(chain_dir, f"res_{layout_name(layout)}_{op}_rank"
                                                   f"{args.rank}.npz"), ctx, got[op])

    # the main path: one call of each op, the counters zeroed just before
    ntt_cuda.reset_launches()
    ntt_cuda32.reset_launches()
    traffic = {}
    for op, fn in ops.items():
        mesh.reset_traffic()
        fn()
        traffic[op] = {c: {k: list(v) for k, v in kinds.items()}
                       for c, kinds in mesh.traffic_by_kind.items()}
    _sync(dev)
    line = {"rank": mesh.rank, "ranks": args.ranks, "backend": args.backend,
            "device": str(dev), "mesh": layout_name(layout), "logn": ctx.poly.logn,
            "logq": args.logq, "slots": ctx.slots, "logDelta": args.logDelta,
            "logp": ctx.logp_prime, "positions": [list(p) for p in mesh.local_positions],
            "equal": equal, "decode_diffs": diffs, "fallbacks": plan.fallbacks,
            "first_calls_s": first_s, "traffic": traffic,
            "graphed": any(isinstance(f, graphs.Program) for f in meng._mesh_jit.values()),
            "eager_why": mesh.eager_why,
            "launches": {"u64": dict(ntt_cuda.LAUNCHES), "u32": dict(ntt_cuda32.LAUNCHES32)}}
    if args.iters:
        line["ms"] = {op: _median_ms(fn, dev, args.iters) for op, fn in ops.items()}
        line["mul_rs_busy_ms"] = _busy_ms(ops["mul_rs"], dev)
    if dev.type == "cuda":
        line["peak_mem_mb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    line["seconds"] = time.perf_counter() - t0
    return line


def _run_virtual(args, ctx, o, msgs, dev, hb: int, layout) -> dict:
    """mul_rs on the same layout in this one process, every position on
    dev: equal to the published result, and its ms."""
    t0 = time.perf_counter()
    _, _, ops, _ = _mesh_ops(args, ctx, o, msgs["A"], dev, hb, layout, None)
    got = ops["mul_rs"]()
    return {"mul_rs_equal": _same(got, o["want_mul_rs"]),
            "mul_rs_ms": _median_ms(ops["mul_rs"], dev, args.iters),
            "seconds": time.perf_counter() - t0}


def _chain(args, rank: int, dev, group, logp: int) -> list[dict]:
    """Every layout on one chain: publish (rank 0) or wait, load, run."""
    from ..context import HeContext
    ctx = HeContext(logn=args.logn, q=1 << args.logq, slots=args.slots,
                    Delta=1 << args.logDelta, logp=logp)
    hb = hoist_bits(ctx, args.layouts)
    chain_dir = os.path.join(args.dir, f"logp{logp}")
    setup = {}
    t0 = time.perf_counter()
    if rank == 0:
        setup["publish"] = _publish(chain_dir, ctx, dev, hb)
        _log(rank, f"logp={logp}: keys, ciphertexts and single-device results published")
    else:
        _wait_for(os.path.join(chain_dir, "ready"), args.timeout)
    t1 = time.perf_counter()
    o, msgs = _load(chain_dir, ctx, dev)
    setup.update({"publish_s" if rank == 0 else "wait_s": t1 - t0,
                  "load_s": time.perf_counter() - t1})
    lines = [dict(_run_layout(args, ctx, o, msgs, dev, hb, lay, group, chain_dir),
                  setup_s=setup) for lay in args.layouts]
    if rank == 0 and args.iters:
        for line, lay in zip(lines, args.layouts):
            line["virtual"] = _run_virtual(args, ctx, o, msgs, dev, hb, lay)
    return lines


def rank_main(args) -> int:
    import torch
    from . import dist as pdist

    torch.set_num_threads(1)
    rank = int(args.rank)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device=cuda: no CUDA device here")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    group = pdist.init_group(rank, args.ranks, args.store, args.backend, args.timeout)
    lines = [ln for logp in args.logps for ln in _chain(args, rank, dev, group, logp)]
    torch.distributed.destroy_process_group()
    ok = True
    for line in lines:
        print(json.dumps(line), flush=True)
        bad = [op for op in OPS if not line["equal"][op]
               or line["decode_diffs"][op] is None or not line["decode_diffs"][op] < TOL]
        if "virtual" in line and not line["virtual"]["mul_rs_equal"]:
            bad.append("mul_rs on the one-process mesh")
        if bad:
            _log(rank, f"logp={line['logp']} mesh {line['mesh']}: {bad} differ from the "
                       f"single-device engine or decode beyond {TOL}")
            ok = False
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _wait_all(procs, timeout: float) -> list:
    """Exit codes of every process; when one fails or the time is up, the
    others are killed (their code is then None)."""
    deadline = time.time() + timeout
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc == 0 for rc in rcs):
            return rcs
        if any(rc not in (None, 0) for rc in rcs) or time.time() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            return rcs
        time.sleep(0.1)


def launch(args, argv) -> int:
    import torch
    if args.backend == "nccl" and (args.device != "cuda"
                                   or torch.cuda.device_count() < args.ranks):
        raise SystemExit(f"--backend=nccl needs a card per rank: {args.ranks} ranks, "
                         f"{torch.cuda.device_count()} cards (use gloo)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")       # every rank runs on this host
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = args.out or tmp
        procs, files = [], []
        for r in range(args.ranks):
            out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gpqhe_tpu_torch.parallel.mp_mul_rs", *argv,
                 f"--rank={r}", f"--dir={run_dir}", f"--store={os.path.join(tmp, 'store')}"],
                stdout=out, stderr=err, cwd=ROOT, env=env))
        t0 = time.time()
        rcs = _wait_all(procs, args.timeout)
        seconds = time.time() - t0
        lines = 0
        for r, (out, err) in enumerate(files):
            out.seek(0)
            for text in out.read().splitlines():
                print(text, flush=True)
                lines += text.startswith("{")
            err.seek(0)
            if rcs[r] != 0:
                print(f"--- rank {r} exit {rcs[r]}, stderr:\n{err.read()[-4000:]}",
                      file=sys.stderr, flush=True)
            out.close()
            err.close()
    ok = (all(rc == 0 for rc in rcs)
          and lines == args.ranks * len(args.layouts) * len(args.logps))
    verdict = f"PASS (bit-exact across {args.ranks} processes)" if ok else "FAIL"
    print(f"mp_mul_rs: {verdict} rcs={rcs} seconds={seconds:.1f}", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    return launch(args, argv)


if __name__ == "__main__":
    sys.exit(main())
