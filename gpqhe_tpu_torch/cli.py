"""Per-op command line of the torch port, mirroring the reference's test
binary surface (ref: tests/gpqhe.c:1277-1408) and gpqhe_tpu/cli.py:

    python -m gpqhe_tpu_torch <op> [sk|pk] [--logn=..] [--logq=..] [--slots=..]
                             [--logDelta=..] [--iter=..] [--alpha=..] [--idx=..]
                             [--logp=29] [--device=cuda|cpu]
                             [--impl=butterfly|matmul|pallas]
                             [--mesh=LxSxB[:virtual]]

--device defaults to cuda, and the engine raises where there is no card;
--logp=29 selects the 30-bit prime chain (and with it the u32 NTT kernel).
--impl selects the NTT backend (default butterfly; pallas is the same
butterfly NTT; matmul the four-step NTT of ops/ntt4.py, not on a mesh).
--mesh=LxSxB runs the key-switch-heavy ops on a (limb, coeff, batch) mesh of
L*S*B distinct GPUs (parallel/engine.py) and returns 2 where the machine has
fewer; --mesh=LxSxB:virtual makes the mesh on the one --device, repeated.

Ops and default parameters match the reference (ref: tests/gpqhe.c:1296-1322);
each op samples a message from the deterministic surf stream, runs the
plaintext model and the homomorphic computation, and reports the max-norm
difference (CHECK_DIFF semantics, ref: tests/gpqhe.c:167-171).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from . import params

OPS = ("ecd", "enc", "add", "mul", "conj", "rot", "gemv", "sum", "idx", "nrm2",
       "inv", "exp", "sigmoid", "log", "cmp", "coeff2slot", "rlsin", "sqrt",
       "bootstrap")

LINEAR_OPS = ("enc", "add", "mul", "conj", "rot", "gemv", "sum", "idx", "nrm2")
NONLINEAR_OPS = ("exp", "log", "sigmoid", "inv", "sqrt", "cmp", "rlsin")


def set_params(op: str, args: list[str]) -> dict:
    """Default parameter selection (ref: tests/gpqhe.c:1277-1345)."""
    p = dict(logn=14, logq=438, slots=16, logDelta=50, iter=5, alpha=2, idx=0,
             logp=params.LOGP, device="cuda", impl="butterfly", mesh=None,
             mesh_virtual=False)
    if op in NONLINEAR_OPS or op in ("coeff2slot", "bootstrap"):
        p.update(slots=4, logDelta=30)
    if op == "sqrt":
        p["iter"] = 6
    if op == "bootstrap":
        # EvalSin range: 2^iter >~ 4*pi*(h/2+1), h=64 -> iter=9; the
        # pipeline consumes 10+iter levels, beyond logn=14's security-table
        # ladder (logq<=438, L=14 at Delta=2^30) — bootstrap needs the
        # logn=15 / logq=881 regime (L=29, q_0=2^11; the reference's cmp
        # config, ref: tests/gpqhe.c:1317-1322).
        p.update(iter=9, logn=15, logq=881)
    if op == "cmp":
        p.update(logn=15, logq=881, slots=4, logDelta=30, iter=5, alpha=2)
    for a in args:
        for key in ("logn", "logq", "slots", "logDelta", "iter", "alpha", "idx",
                    "logp"):
            if a.startswith(f"--{key}="):
                p[key] = int(a.split("=", 1)[1])
        if a.startswith("--device="):
            p["device"] = a.split("=", 1)[1]
        if a.startswith("--impl="):
            p["impl"] = a.split("=", 1)[1]
        if a.startswith("--mesh="):
            # LxSxB over (limb, coeff, batch), ":virtual" for a mesh that
            # repeats the one device
            dims, _, mode = a.split("=", 1)[1].partition(":")
            p["mesh"] = tuple(int(x) for x in dims.split("x"))
            p["mesh_virtual"] = mode == "virtual"
            if len(p["mesh"]) != 3 or min(p["mesh"]) < 1 or mode not in ("", "virtual"):
                raise ValueError(f"{a}: expected --mesh=LIMBxCOEFFxBATCH[:virtual]")
    return p


def check_diff(name: str, got, expect, tol: float = 1e-5) -> bool:
    diff = float(np.max(np.abs(np.asarray(got) - np.asarray(expect))))
    status = "ok" if diff < tol else "FAIL"
    print(f"[{status}] {name}: diff = {diff:g}")
    return diff < tol


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in OPS:
        print(f"usage: python -m gpqhe_tpu_torch <{'/'.join(OPS)}> [sk/pk] "
              f"--logn=num --logq=num --slots=num --logDelta=num --iter=num "
              f"--logp=29 --device=cuda|cpu --impl=butterfly|matmul|pallas "
              f"--mesh=LxSxB[:virtual]")
        return 1
    op = argv[0]
    key = argv[1] if len(argv) > 1 and argv[1] in ("sk", "pk") else "sk"
    p = set_params(op, argv[1:])

    if p["device"] not in ("cuda", "cpu"):
        print(f"--device={p['device']}: expected cuda or cpu")
        return 1
    if p["impl"] not in ("butterfly", "matmul", "pallas"):
        print(f"--impl={p['impl']}: expected butterfly, matmul or pallas")
        return 1
    if p["impl"] == "matmul" and p["mesh"]:
        # the mesh's sharded programs run the butterfly NTT (MeshCKKS refuses)
        print("--impl=matmul does not run on a mesh: the sharded programs use the "
              "butterfly NTT's order; drop --mesh or use --impl=butterfly")
        return 2

    from .algo import linalg, nonlinear
    from .context import HeContext
    from .ring import sample as smp
    from .scheme.engine import CKKS
    from .substrate.surf import Surf
    from .utils.info import show_ctx_params

    t0 = time.time()
    ctx = HeContext(p["logn"], 1 << p["logq"], p["slots"], 1 << p["logDelta"],
                    logp=p["logp"])
    if p["mesh"]:
        import torch
        from .parallel.engine import MeshCKKS
        from .parallel.mesh import make_he_mesh3
        L, S, B = p["mesh"]
        if p["mesh_virtual"]:
            devices = [torch.device(p["device"])] * (L * S * B)
        else:
            ndev = torch.cuda.device_count() if p["device"] == "cuda" else 1
            if ndev < L * S * B:
                # no silent single-device run
                print(f"--mesh={L}x{S}x{B} needs {L*S*B} devices; this session has "
                      f"{ndev}.  For a virtual mesh on the one device run with\n"
                      f"  --mesh={L}x{S}x{B}:virtual")
                return 2
            devices = None if p["device"] == "cuda" else ["cpu"]
        mesh = make_he_mesh3(L * S * B, limb=L, coeff=S, devices=devices)
        print(f"mesh mode: {dict(mesh.shape)}")
        eng = MeshCKKS(ctx, mesh, rng=Surf())
    else:
        # "cuda" is the engine's own default: it raises where there is no card
        eng = CKKS(ctx, rng=Surf(), device=None if p["device"] == "cuda" else "cpu",
                   ntt_impl=p["impl"])
    show_ctx_params(ctx)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)

    if op == "ecd":
        ok = check_diff("ecd/dcd", eng.dcd(eng.ecd(m0)), m0)
        return 0 if ok else 2

    print("Generating sk and pk ... ", end="", flush=True)
    pk, sk = eng.keypair()
    print("done.")
    enc = (lambda pt: eng.enc_sk(pt, sk)) if key == "sk" else (lambda pt: eng.enc_pk(pt, pk))

    need_rlk = op in ("mul", "nrm2", "inv", "exp", "sigmoid", "log", "cmp",
                      "sqrt", "rlsin", "bootstrap")
    need_ck = op in ("conj", "nrm2", "coeff2slot", "rlsin", "bootstrap")
    need_rk = op in ("rot", "gemv", "sum", "idx", "nrm2", "coeff2slot", "bootstrap")
    rlk = ck = rk = None
    if need_rlk:
        print("Generating rlk ... ", end="", flush=True)
        rlk = eng.genrlk(sk)
        print("done.")
    if need_ck:
        print("Generating ck ... ", end="", flush=True)
        ck = eng.genck(sk)
        print("done.")
    if need_rk:
        print("Generating rk ... ", end="", flush=True)
        if op in ("coeff2slot", "bootstrap"):
            from . import bootstrap as _bs
            rk = eng.genrk(sk, _bs.bootstrap_rotations(ctx))
        else:
            rk = eng.genrk(sk)
        print("done.")

    ct = enc(eng.ecd(m0))
    ok = True
    if op == "enc":
        ok = check_diff("enc/dec", eng.dcd(eng.dec(ct, sk)), m0)
    elif op == "add":
        m1 = smp.sample_z01vec(eng.rng, ctx.slots)
        ct1 = enc(eng.ecd(m1))
        ok = check_diff("add", eng.dcd(eng.dec(eng.add(ct, ct1), sk)), m0 + m1)
    elif op == "mul":
        m1 = smp.sample_z01vec(eng.rng, ctx.slots)
        ct1 = enc(eng.ecd(m1))
        out = eng.rs(eng.mul(ct, ct1, rlk))
        ok = check_diff("mul", eng.dcd(eng.dec(out, sk)), m0 * m1)
    elif op == "conj":
        ok = check_diff("conj", eng.dcd(eng.dec(eng.conj(ct, ck), sk)), np.conj(m0))
    elif op == "rot":
        for r in range(ctx.slots):
            got = eng.dcd(eng.dec(eng.rot(ct.copy(), r, rk), sk))
            ok &= check_diff(f"rot {r}", got, np.concatenate([m0[r:], m0[:r]]))
    elif op == "gemv":
        A = smp.sample_z01vec(eng.rng, ctx.slots * ctx.slots)
        out = linalg.gemv(eng, A, ct, rk)
        ok = check_diff("gemv", eng.dcd(eng.dec(out, sk)),
                        A.reshape(ctx.slots, ctx.slots) @ m0)
    elif op == "sum":
        got = eng.dcd(eng.dec(linalg.he_sum(eng, ct, rk), sk))
        ok = check_diff("sum", got[0], np.sum(m0))
    elif op == "idx":
        got = eng.dcd(eng.dec(linalg.he_idx(eng, ct, p["idx"], rk), sk))
        ok = check_diff("idx", got[p["idx"]], m0[p["idx"]])
    elif op == "nrm2":
        got = eng.dcd(eng.dec(linalg.he_nrm2(eng, ct, rlk, ck, rk), sk))
        ok = check_diff("nrm2", got[0], np.sum(np.abs(m0) ** 2))
    elif op == "inv":
        an, bn = 2 - m0, 1 - m0
        for _ in range(p["iter"]):
            bn = bn * bn
            an = an * (bn + 1)
        out = nonlinear.he_inv(eng, ct, rlk, p["iter"])
        ok = check_diff("inv", eng.dcd(eng.dec(out, sk)), an, tol=1e-4)
    elif op == "sqrt":
        out = nonlinear.he_sqrt(eng, ct, rlk, p["iter"])
        ok = check_diff("sqrt", eng.dcd(eng.dec(out, sk)), np.sqrt(m0), tol=1e-2)
    elif op == "exp":
        out = nonlinear.he_exp(eng, 1.0, ct, rlk, p["iter"])
        ok = check_diff("exp", eng.dcd(eng.dec(out, sk)), np.exp(m0), tol=1e-4)
    elif op == "sigmoid":
        out = nonlinear.he_sigmoid(eng, ct, rlk)
        ok = check_diff("sigmoid", eng.dcd(eng.dec(out, sk)),
                        1 / (1 + np.exp(-m0)), tol=1e-3)
    elif op == "log":
        ctl = enc(eng.ecd(m0 - 0.0))  # evaluator computes log(1+x)
        out = nonlinear.he_log(eng, ctl, rlk)
        ok = check_diff("log", eng.dcd(eng.dec(out, sk)), np.log(1 + m0), tol=1e-2)
    elif op == "cmp":
        m1 = smp.sample_z01vec(eng.rng, ctx.slots)
        ct1 = enc(eng.ecd(m1))
        out = nonlinear.he_cmp(eng, ct, ct1, rlk, p["iter"], p["alpha"])
        got = np.round(eng.dcd(eng.dec(out, sk)).real)
        ok = check_diff("cmp", got, (m0.real > m1.real).astype(float), tol=0.5)
    elif op in ("coeff2slot", "rlsin", "bootstrap"):
        from . import bootstrap as bs
        bctx = bs.BootstrapContext(eng)
        if op == "rlsin":
            out = bs.rlsin(eng, 2 * np.pi, ct, rlk, ck, p["iter"])
            ok = check_diff("rlsin", eng.dcd(eng.dec(out, sk)),
                            np.sin(2 * np.pi * m0) / (2 * np.pi), tol=1e-3)
        elif op == "coeff2slot":
            with bs.raised_delta(eng, float(ctx.q[ct.l])):
                ct_r = ct.copy()
                ct_r.nu = eng.Delta
                ct0, ct1 = bs.coeff2slot(eng, bctx, ct_r, ck, rk)
                out = bs.slot2coeff(eng, bctx, ct0, ct1, rk)
            out.nu = float(1 << p["logDelta"])
            ok = check_diff("coeff2slot+slot2coeff", eng.dcd(eng.dec(out, sk)),
                            m0, tol=1e-3)
        else:
            while ct.l > 1:
                ct = eng.moddown(ct)
            out = bs.bootstrap(eng, bctx, ct, rlk, ck, rk, iter=p["iter"])
            ok = check_diff("bootstrap", eng.dcd(eng.dec(out, sk)), m0, tol=1e-2)
    if eng.device.type == "cuda":
        import torch
        from .ops import ntt4_cuda, ntt_cuda, ntt_cuda32
        if eng.ring.ntt_impl == "matmul":
            counts = ntt4_cuda.LAUNCHES
        else:
            counts = (ntt_cuda32.LAUNCHES32 if eng.ring.ntt_mod is ntt_cuda32
                      else ntt_cuda.LAUNCHES)
        print(f"device {torch.cuda.get_device_name(eng.device)}: "
              f"NTT kernel launches {dict(counts)}")
    if p["mesh"]:
        print(f"mesh programs built: {sorted(eng._mesh_jit, key=str)}")
    print(f"total {time.time()-t0:.1f}s")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
