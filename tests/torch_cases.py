"""Cases of the port's tests, written once for the CPU tests, the card's
tests (tests/test_torch_cuda.py) and chip_smoke.py's kernel phases.

- the NTT: the kernel-vs-twin shapes of the paths (CASES, NTT16), the
  rings they run at (kernel_ring) and the bootstrap's (bootstrap_cases);
- the elementwise kernels K4-K7: every entry at the shapes the paths give
  it (elementwise_cases, ring16_cases at logn=16), at the edges of each
  design (elementwise_edge_cases, rns_edge_cases, modmath_edge_cases), how
  a kernel's output is held to its plain version's (ew_compare) and the
  launch counters (ew_counters);
- the engine programs as CUDA graphs against the same programs under
  graphs.disabled() (graph_case, graph_check), and the mesh's (MESH_HEADS,
  mesh_replays_match, mixed_devices);
- the rest of the JAX package's test suite (crt_chain_case,
  gemv_packing_case, c2s_packing_case, full_width_checks, oracle_module),
  each case written for any engine: the CPU tests hand gemv_packing_case
  and c2s_packing_case the JAX package's names (api=);
- K8, the four-step NTT's stage (ntt4_edge_cases, ntt4_compare,
  ntt4_max_sums, NTT4_PATH).

Imports neither jax nor gpqhe_tpu, so it runs on the card's machine:
tests/ on sys.path (pytest puts it there; chip_smoke.py does too) and the
repository root (for gpqhe_tpu_torch).
"""

from __future__ import annotations

import contextlib
import time

# ---------------------------------------------------------------------------
# the NTT kernels (csrc/ntt.cu, ntt32.cu)
# ---------------------------------------------------------------------------

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
LOGQ = {14: 438, 15: 881}      # the rings the paths run at, by logn
MODES = ("fwd", "inv", "inv_scaled")
CHAIN_LOGP = {"ntt": 59, "ntt32": 29}      # each NTT kernel's chain

_RINGS = {}


def kernel_ring(kernel: str, logn: int, dim: int):
    """A RingEngine on the card over a chain of the kernel's prime width with
    >= dim primes (at logn=14 and 15: the paths' rings, logq=438 and 881)."""
    import torch
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ring.poly import RingEngine
    logp = CHAIN_LOGP[kernel]
    key = (logp, logn) if logn in LOGQ else (logp, logn, dim)
    if key not in _RINGS:
        if logn in LOGQ:
            pctx = PolyContext(logn, 1 << LOGQ[logn], logp=logp)
        else:
            pctx = PolyContext(logn, 1 << (logp * dim), logp=logp, dim_cap=dim)
        _RINGS[key] = RingEngine(pctx, device=torch.device("cuda"))
    return _RINGS[key]


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


# ---------------------------------------------------------------------------
# the elementwise kernels K4-K7 (csrc/modmath.cu, rns.cu, limbs.cu): the GPU
# counterparts of XLA's fusion of the JAX package's jnp chains
# ---------------------------------------------------------------------------

# 32-bit multiply instructions per u64 Montgomery product: the 64x64 high
# product (4) and the low product (3) of a * b, the low product u = lo * pinv
# (3) and the high product of u * p (4); a mulmod is two of them
IMAD_MONT = 14
# the elementwise kernel's mulmod: one Barrett reduction a word (the 128-bit
# product a b, 7; the high product of x mu, 4; the low product q p, 3)
IMAD_BARRETT = 14
EW_BATCH = 8       # mul_rs_batch's B
EW_N1 = 4          # baby steps of a hoisted gemv step (slots=16 BSGS; slots=4 fully hoisted)
# K5's shape classes that the bootstrap (logn=15) launches most, timed on
# chip_smoke.py's kernels15 lines: (entry, dim, leading axes, multipliers of
# a sum); a card test counts a bootstrap's launches by shape class
# (modmath_cuda.SHAPES) and fails where one of these is no longer among them
BOOT15_K5 = (("modmath_cross_terms", 26, (4,), 0), ("modmath_key_products", 47, (), 0),
             ("modmath_key_products", 44, (), 0), ("modmath_mulmod_sum", 47, (EW_N1,), 2),
             ("modmath_mulmod_sum", 16, (EW_N1,), 0), ("modmath_mulmod", 14, (), 0),
             ("modmath_mulmod", 16, (), 0))


def digit_product_case(y, plan, kd: int, scale) -> tuple:
    """(kern, plain, inputs, out_words, imad, kw) of the digit product of a
    reconstruct as elementwise_cases' add takes them, kw its u8 tensor-core
    operations (int8_ops: 2 rows (nb dim) (2 kd), nb =
    rns_cuda.residue_bytes) and kd: rns._digit_partials (the kernel on a
    card) against rns.plain_digit_partials (16-bit split, f64 matmul)."""
    from gpqhe_tpu_torch.ops import rns, rns_cuda
    dim = y.shape[-2]
    rows = y.numel() // dim
    nb = rns_cuda.residue_bytes(plan.nd)
    return ((lambda: rns._digit_partials(y, plan, kd, scale)),
            (lambda: rns.plain_digit_partials(y, plan, kd, scale)),
            [y], rows * (kd + 1), IMAD_MONT * y.numel() if scale else 0,
            {"int8_ops": 2 * rows * nb * dim * 2 * kd, "kd": kd})


def decompose_imad(out_words: int, k: int, pmax: int) -> int:
    """32-bit multiplies of rns.cu's decompose: per output word, for each
    limb the low and high 32-bit products of the limb and each 32-bit half
    of its constant (two halves for primes past 32 bits, else one), and one
    Montgomery reduction (u = lo * pinv, 3, and the high product of u * p,
    4).  (The earlier design did (k + 1) // 2 Montgomery products of
    IMAD_MONT: the case's imad_mont.)"""
    halves = 2 if pmax >> 32 else 1
    return out_words * (2 * halves * k + 7)


def decompose_routes(a, ba, wts, src) -> dict:
    """{route: fn} of both routes of rns_cuda.decompose on the same operands
    (the dispatcher takes one by K; chip_smoke.py times both where K* is
    set): "imad" the integer units' kernel, "mma" the tensor cores'."""
    from gpqhe_tpu_torch.ops import rns_cuda
    return {r: (lambda f=f: f(a, ba.ps, ba.pinv, wts, src))
            for r, f in (("imad", rns_cuda.decompose_imad), ("mma", rns_cuda.decompose_mma))}


def decompose_route_kw(a, ba, wts, src, rows: int, k: int, primes) -> dict:
    """A decompose case's routes (decompose_routes), its limbs k and each
    route's operations for the bound (route_ops): the IMAD route's 32-bit
    multiplies (decompose_imad), the tensor-core route's u8 operations, 2 for
    each of a row's 4 k bytes against each of the table's nb dim byte
    columns (nb = rns_cuda.const_bytes of the largest prime)."""
    from gpqhe_tpu_torch.ops import rns_cuda
    dim, pmax = len(primes), max(primes)
    return dict(k=k, routes=decompose_routes(a, ba, wts, src), route_ops={
        "imad": {"imad": decompose_imad(rows * dim, k, pmax)},
        "mma": {"imad": 0, "int8_ops": 2 * rows * 4 * k * rns_cuda.const_bytes(pmax) * dim}})


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


def ew_by_kernel(counts: dict) -> dict:
    """Launches per kernel (K4-K7) from per-entry counts (the counts by
    shape class left out)."""
    out = {k: 0 for k in ("decompose", "modmath", "crt", "limbs")}
    for name, v in counts.items():
        if " " not in name:
            out[name.split("_")[0]] += v
    return out


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
            imad_mont=IMAD_MONT * out_words * ((klv + 1) // 2), signed_bits=src, dim=dim,
            **decompose_route_kw(a, ba, wts, src, out_words // dim, klv,
                                 ring.pctx.primes[:dim]))

    # K6 the CRT reconstruct: the digit product and lift on their own inputs,
    # and the whole reconstruct on values that meet its bounds; the product
    # at the key switch's (fast, the ciphertext's limbs) and its exact widths
    for dim, lead, scaled, kd in ((dim_m, (), False, 2 * klv), (dim_m, (3,), False, 2 * klv),
                                  (dim_s, (), True, None)):
        ba, plan = ring.ba(dim), ring.recon(dim)
        y = res(dim, lead)
        scale = (ba.phatinv_mont, ba.ps, ba.pinv) if scaled else None
        *args, kw = digit_product_case(y, plan, kd or plan.ds, scale)
        add("crt_digit_split", y.shape, *args, **kw)
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
        sd = sd.to(torch.int64)        # the lift takes digit_sums' int64 sums
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
    # the fill of a sparse plaintext: const_pt's rows 0 and n/2 (the first,
    # timed), ecd's 2 slots rows gap apart; the rows' limbs travel in the
    # launch's parameters, so its bytes are the output's
    for stride in (n // 2, (n // 2) // slots):
        rows = ew_words(rng, (n // stride, kq), "cpu", 32).numpy().astype(np.uint32)
        add("limbs_fill_rows", [n, kq],
            lambda rows=rows, s=stride: lb.fill_rows(rows, n, s, device),
            lambda rows=rows, s=stride: lb.plain_fill_rows(rows, n, s, device), [], n * kq, 0)
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


# the lift at the edges of its design: (logp, dim, k_out (None: exact, the
# plan's ks limbs), kd (None: the plan's), center); ks = 3, 16, 31, 33, 64,
# 66, 114 on the 59-bit chain at dim 1, 8, 16, 17, 34, 35, 61 and 30, 32 on
# logp=29 at 31, 34; five and six chunks: ks = 129, 147, 160, 162, 191 at dim
# 69, 79, 86, 87, 103, and the fast lift of 104 primes to 161 (kd odd, below
# 2 k_out) and 192 limbs
LIFT_EDGES = (
    (59, 1, None, None, True), (59, 8, None, None, False), (59, 16, None, None, True),
    (59, 17, None, None, True), (59, 34, None, None, False), (59, 35, None, None, True),
    (59, 61, None, None, True), (29, 31, None, None, True), (29, 34, None, None, True),
    (59, 8, 5, 9, True), (59, 8, 16, None, True), (29, 16, 7, 14, True),
    (59, 24, 32, None, True), (59, 24, 33, 61, True), (59, 69, 128, None, False),
    (59, 69, None, None, True), (59, 79, None, None, True), (59, 86, None, None, False),
    (59, 87, None, None, True), (59, 103, None, None, True), (59, 104, 161, 319, True),
    (59, 104, 192, None, False))


def elementwise_edge_cases(device, seed: int = 9) -> list:
    """K7 and the CRT lift at the edges of their designs, each a dict with
    entry, shape, kern and plain (the plain version on the same tensors):
    every entry at every K of EDGE_K on EDGE_ROWS rows, edge rows first (a
    carry and a borrow through every limb, equal rows, rows equal but for
    the top limb); operands read through cuda_build.strides3 in every form:
    a constant row (stride 0), an operand broadcast over a leading axis
    (R1 > 1, the rows do not collapse), row-strided and limb-strided views,
    per-row bits as bool and int64; the lift at one, two, four, five and six
    chunks of 32 limbs (3-191 limbs on the exact path, up to 192 on the fast
    one: LIFT_EDGES), on int64 digit sums (the card's, rns_cuda.digit_sums'),
    odd kd, kd < 2 k_out and random estimates that reach both clamps and
    both sides of the 1/2 rule."""
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

    n = 1 << 10
    rings = {59: PolyContext(10, q=1 << 20, dim_cap=72),
             29: PolyContext(10, q=1 << 20, logp=29, dim_cap=72)}
    wide = PolyContext(10, q=1 << 20, dim_cap=max(d for _, d, *_ in LIFT_EDGES))
    R = rows
    for logp, dim, k_out, kd, center in LIFT_EDGES:
        ring = rings[logp] if dim <= 72 else wide
        plan = rns.make_recon_plan(ring, dim, device)
        ba = rns.make_basis_arrays(ring, dim, device)
        kd = kd or (plan.ds if k_out is None else min(2 * k_out, plan.ds))
        y = ew_residues(rng, ring.primes[:dim], (dim, n), device)
        sd, af = rns.plain_digit_partials(y, plan, kd, (ba.phatinv_mont, ba.ps, ba.pinv))
        sd, af = sd[:R], af[:R]
        noisy = torch.from_numpy(rng.uniform(-1.5, dim + 1.5, size=R)).to(device)
        sr = torch.from_numpy(rng.integers(0, 1 << 48, size=(R, kd))).to(device)
        for s_, a_, what in ((sd.to(torch.int64), af, "sums"), (sr, noisy, "noisy")):
            add("_lift", [logp, dim, k_out, R, kd, what], s_, a_, plan, center, k_out)
    return cases + rns_edge_cases(device, rings) + modmath_edge_cases(device, rings)


# decompose at the edges of its designs: (logp, dim, K, src_bits, layout):
# dims around the IMAD kernel's tiles of 16 primes (1-47) and the tensor-core
# kernel's 256 byte columns (33 primes of 8 bytes, 65 of 4: a second tile of
# columns), K = 1 (the c1 of a one-weight row), 2, odd K, 64 and 65 and 125
# (one and two staged chunks of 64 limbs; the tensor cores' chunks of 32),
# 300 (a reduction after 256 limbs and a second group), src_bits at 1, 32 K
# - 5 and 32 K; on the three widths of prime (one, two and three 24-bit
# chunks a constant; 8 and 4 bytes a constant); S = 0, three slabs, a row
# broadcast over two slabs, rows 2K + 3 words apart and limbs two words apart
# (copied by the wrapper), a mesh shard's primes (rows 4 .. dim + 3 of a
# basis); rns_edge_cases adds K* - 1 and K* (rns_cuda.MMA_MIN_LIMBS)
DECOMPOSE_EDGES = (
    (59, 16, 14, None, "lead"), (59, 17, 13, None, "plain"), (59, 47, 28, 32 * 28, "plain"),
    (59, 31, 28, 32 * 28 - 5, "row_strided"), (59, 8, 1, None, "plain"), (59, 8, 1, 1, "plain"),
    (59, 33, 2, 59, "broadcast"), (59, 16, 125, None, "plain"),
    (59, 16, 125, 32 * 125 - 5, "limb_strided"), (59, 5, 64, 32 * 64, "plain"),
    (59, 5, 65, 1, "plain"), (59, 3, 300, None, "plain"), (59, 3, 300, 32 * 300, "plain"),
    (59, 16, 14, None, "S0"), (29, 31, 14, None, "plain"), (29, 47, 28, 32 * 28 - 5, "lead"),
    (29, 16, 1, 1, "plain"), (29, 20, 125, 32 * 125, "broadcast"), (9, 6, 3, None, "plain"),
    (9, 6, 14, 32 * 14, "lead"), (9, 5, 1, 1, "plain"), (9, 6, 125, 32 * 125 - 5, "plain"),
    (9, 6, 300, None, "row_strided"), (59, 33, 40, None, "plain"),
    (59, 33, 55, 32 * 55, "shard"), (29, 65, 30, 32 * 30 - 5, "plain"),
    (29, 20, 57, None, "shard"))
# the digit product at the edges of its design: (logp, dim, n, lead, scaled,
# layout, k_out (None: the exact width, the plan's ds digit sums)): byte
# columns 2 kd within one warp's 64 (a block of 256 rows), two warps' (128
# rows), four (64 rows) and past 256 (a second block of columns: the key
# switch's 47 primes exact, the lift's widest row, 128 limbs at 68 primes);
# n a multiple of the block's rows and not (odd, below one block); depth
# NB dim one chunk of 128 bytes, past it (17 primes: 136 bytes) and five
# chunks; residues of 8 bytes (59-bit chain) and 4 (logp=29, and the logp=9
# chain's 10-bit primes); S = 0, residues broadcast over two slabs, a prime
# slice of a wider stack, every other coefficient, a view one word off
# 16-byte alignment, a strided inv_p, and a mesh shard's plan whose rows
# past the basis are zero (make_recon_plan(rows=...))
DIGIT_EDGES = (
    (59, 16, 1024, (), False, "plain", 14), (59, 16, 518, (), True, "plain", None),
    (59, 17, 519, (), True, "plain", None), (59, 47, 1024, (3,), True, "plain", None),
    (59, 1, 519, (), False, "plain", None), (59, 9, 64, (2,), True, "plain", 5),
    (59, 16, 518, (), False, "S0", 14), (59, 24, 518, (), True, "broadcast", None),
    (59, 16, 1024, (), True, "prime_slice", 16), (59, 17, 518, (), False, "coef_strided", 14),
    (59, 16, 518, (2,), True, "unaligned", None), (59, 8, 1024, (), False, "inv_p_strided", None),
    (59, 8, 518, (), False, "shard", None), (59, 68, 300, (), True, "plain", None),
    (29, 31, 518, (), True, "plain", None), (29, 47, 519, (2,), False, "plain", 20),
    (29, 16, 1024, (), True, "unaligned", None), (9, 6, 16, (), True, "plain", None),
    (9, 5, 519, (), False, "plain", None), (9, 6, 518, (3,), True, "broadcast", None))


def rns_edge_cases(device, rings: dict, seed: int = 10) -> list:
    """decompose and the digit product at the edges of their designs
    (DECOMPOSE_EDGES, DIGIT_EDGES), each a dict with entry, shape, op and
    args (ops/rns_cuda.py's entry and its arguments), kern (the dispatcher)
    and plain (the plain version on the same tensors).  decompose's rows:
    EDGE_ROWS (a partial block of 64), the first all 0xFFFFFFFF, all 0 and
    0xFFFFFFFF below a zero top limb, then the sign bit alone, all bits
    below it, and p - 1, p, p + 1 of the first prime (where K holds them)."""
    import dataclasses

    import numpy as np
    import torch
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ops import rns, rns_cuda
    from gpqhe_tpu_torch.substrate import bigint

    rng = np.random.default_rng(seed)
    rings = dict(rings)
    rings[9] = PolyContext(4, **CRT_CHAIN)
    cases = []

    def case(entry, shape, op, args, kern, plain):
        cases.append(dict(entry=entry, shape=list(shape), op=op, args=args, kern=kern,
                          plain=plain))

    rows = EDGE_ROWS
    kstar = rns_cuda.MMA_MIN_LIMBS
    for logp, dim, k, src, layout in DECOMPOSE_EDGES + (
            (59, 24, kstar - 1, None, "lead"), (59, 24, kstar, 32 * kstar - 5, "plain"),
            (29, 31, kstar - 1, 32 * (kstar - 1), "plain"), (29, 31, kstar, None, "lead")):
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
        if layout == "shard":
            # the mesh's shard: its rows of the basis's constants, each contiguous
            wide = rns.make_basis_arrays(ring, dim + 4, device)
            ba = dataclasses.replace(ba, ps=wide.ps[4:].clone(), pinv=wide.pinv[4:].clone())
            w = torch.from_numpy(rns.make_decomp_weights(ring, dim + 4, k)[4:].view(np.int64)
                                 ).to(device)
        args = (a, ba.ps, ba.pinv, w, src)
        plain = ((lambda a=a, ba=ba, w=w: rns.plain_decompose_core(a, ba.ps, ba.pinv, w))
                 if src is None else
                 (lambda a=a, ba=ba, w=w, src=src:
                  rns.plain_decompose_signed(a, ba.ps, ba.pinv, w, src)))
        case("decompose", [logp, dim, src, layout] + list(a.shape), "decompose", args,
             lambda args=args: rns.decompose_core(*args), plain)

    for logp, dim, n, lead, scaled, layout, k_out in DIGIT_EDGES:
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
        elif layout == "inv_p_strided":
            plan = dataclasses.replace(
                plan, inv_p=torch.stack([plan.inv_p, plan.inv_p + 1], dim=-1)[:, 0])
        elif layout == "shard":
            # rows 4 .. dim + 3 of the basis: the last 4 past it
            plan = rns.make_recon_plan(ring, dim, device, rows=(4, dim + 4))
            y = ew_residues(rng, ring.primes[4:dim + 4], (dim, n), device)
        scale = (ba.phatinv_mont[:dim], ba.ps[:dim], ba.pinv[:dim]) if scaled else None
        kd = min(2 * k_out, plan.ds) if k_out else plan.ds
        args = (y, plan, kd, scale)
        case("crt_digit_split", [logp, plan.nd, scaled, layout, kd] + list(y.shape),
             "digit_sums", args, lambda args=args: rns._digit_partials(*args),
             lambda args=args: rns.plain_digit_partials(*args))
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
    version's: torch.equal on every tensor; for the digit product the int64
    digit sums against the plain version's f64 ones as the values they
    stand for, mod 2^(16 kd) (the columns differ: digit_sums sums byte
    columns, rns_cuda.digit_sums), and the f64 af estimate (summed in
    another order) held to a relative 2^-45 instead (its use tolerates far
    more: ops/rns.py reconstruct_core)."""
    import torch
    if isinstance(got, tuple):
        Y, af = got
        pY, paf = want
        if Y.dtype != pY.dtype:
            from gpqhe_tpu_torch.ops import limbs as lb
            kd = Y.shape[-1]
            Y, pY = (lb.plain_from_digits16(v.to(torch.int64), kd // 2) for v in (Y, pY))
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


# ---------------------------------------------------------------------------
# the logn=16 ring of gpubench's ckks-n16-q1751
# ---------------------------------------------------------------------------

NTT16 = [(mode, (lead, dim, 1 << 16)) for dim, lead in ((60, 4), (90, 2))
         for mode in ("fwd", "inv", "inv_scaled")]


# the lift at the logn=16 ring: (primes, k_out) whose digit sums [2^16, 2K]
# lift to K limbs: the exact lift at K = 46, 88 (the n14 and n15 key
# switches' widths) and 57 (30 primes: the n16 key switch's exact rows), the
# fast lift of the n16 key switch's 90 primes to a ciphertext's 55 limbs,
# and the exact lift past four chunks of 32: 147 limbs (79 primes, five
# chunks: the n16 key switch at level 37) and 167 (90 primes, six chunks:
# the widest basis of the chain)
LIFT16 = ((24, None), (47, None), (30, None), (90, 55), (79, None), (90, None))
# the lift past four chunks at [2^16, 2K -> K] (the card's tests): exact at
# 129, 147 and 167 limbs (69, 79 and 90 primes), fast from 104 primes to 192
LIFT_WIDE16 = ((69, None), (79, None), (90, None), (104, 192))
# the digit product there: (primes, rows of the stack, leading axes, scaled,
# k_out (None: exact)): mul_rs's product of three polys to 55 limbs, the key
# switch's c (both halves) to 55 and its exact sub-basis r over the first 30
# of the 90 rows, scaled
DIGITS16 = ((60, 60, (3,), False, 55), (90, 90, (2,), False, 55), (30, 90, (2,), True, None))


def lift16_case(pctx, ba, k_out, rng, device) -> tuple:
    """The lift of [n, 2K] int64 digit sums of random residues over the
    basis ba of pctx (its first ba.dim primes) to K limbs (k_out, or the
    exact path's plan.ks): (shape [n, kd, K], kern, plain, its operands, the
    words it writes)."""
    import torch
    from gpqhe_tpu_torch.ops import rns
    n, dim = pctx.n, ba.dim
    plan = rns.make_recon_plan(pctx, dim, device)
    kd = min(2 * k_out, plan.ds) if k_out else plan.ds
    y = ew_residues(rng, pctx.primes[:dim], (dim, n), device)
    sd, af = rns.plain_digit_partials(y, plan, kd, (ba.phatinv_mont, ba.ps, ba.pinv))
    sd = sd.to(torch.int64)
    k = k_out or plan.ks
    return ([n, kd, k], lambda: rns._lift(sd, af, plan, True, k_out),
            lambda: rns.plain_lift(sd, af, plan, True, k_out), [sd, af], n * k)


def ring16_cases(device, seed: int = 16) -> dict:
    """{entry: [case, ...]} as elementwise_cases gives them, at the logn=16
    shapes of gpubench's ckks-n16-q1751 (a ciphertext of 55 limbs, the
    product's basis 60 primes, the key switch's 90) on the 59-bit chain:
    decompose of [2^16, 55] limbs into 60 primes and, signed, into 90; the
    digit product at DIGITS16; the lift at LIFT16 (lift16_case); the fill of a
    sparse ecd's 8 rows of 55 limbs (slots 4, gap 2^13).  (The NTT's shapes
    are NTT16, against its twin.)"""
    import numpy as np
    import torch
    from gpqhe_tpu_torch.context import PolyContext
    from gpqhe_tpu_torch.ops import limbs as lb
    from gpqhe_tpu_torch.ops import rns
    from gpqhe_tpu_torch.ring.poly import RingEngine

    rng = np.random.default_rng(seed)
    n, kq = 1 << 16, 55
    ring = RingEngine(PolyContext(16, q=1 << 20, dim_cap=max(d for d, _ in LIFT16)),
                      device=device)
    cases = {}

    def res(dim, lead=()):
        return ew_residues(rng, ring.pctx.primes[:dim], lead + (dim, n), device)

    def add(entry, shape, kern, plain, inputs, out_words, imad, **kw):
        cases.setdefault(entry, []).append(dict(
            shape=list(shape), kern=kern, plain=plain, imad=imad,
            bytes=nbytes(*inputs) + 8 * out_words, **kw))

    a = ew_limbs(rng, (n, kq), device)
    for dim, src in ((60, None), (90, 32 * kq)):
        ba, wts = ring.ba(dim), ring.weights(dim, kq)
        plain = ((lambda ba=ba, wts=wts: rns.plain_decompose_core(a, ba.ps, ba.pinv, wts))
                 if src is None else
                 (lambda ba=ba, wts=wts, src=src:
                  rns.plain_decompose_signed(a, ba.ps, ba.pinv, wts, src)))
        add("decompose", [n, kq, dim],
            lambda ba=ba, wts=wts, src=src: rns.decompose(a, ba, wts, src_bits=src), plain,
            [a, wts], n * dim, decompose_imad(n * dim, kq, max(ring.pctx.primes[:dim])),
            **decompose_route_kw(a, ba, wts, src, n, kq, ring.pctx.primes[:dim]))
    for dim, rows, lead, scaled, k_out in DIGITS16:
        ba, plan = ring.ba(dim), rns.make_recon_plan(ring.pctx, dim, device)
        y = res(rows, lead)[..., :dim, :]
        scale = (ba.phatinv_mont, ba.ps, ba.pinv) if scaled else None
        *args, kw = digit_product_case(y, plan, 2 * k_out if k_out else plan.ds, scale)
        add("crt_digit_split", y.shape, *args, **kw)
    for dim, k_out in LIFT16:
        *args, inputs, out_words = lift16_case(ring.pctx, ring.ba(dim), k_out, rng, device)
        add("crt_lift", *args, inputs, out_words, 0)
    gap = (n // 2) // 4
    rows = rng.integers(0, 1 << 32, size=(n // gap, kq), dtype=np.uint64).astype(np.uint32)
    add("limbs_fill_rows", [n, kq, gap], lambda: lb.fill_rows(rows, n, gap, device),
        lambda: lb.plain_fill_rows(rows, n, gap, device), [], n * kq, 0)
    return cases


# ---------------------------------------------------------------------------
# the mesh's sharded programs (parallel/mesh.py)
# ---------------------------------------------------------------------------

MESH_HEADS = {"mul_rs": "mul_rs", "rot": "rot", "conj": "rot", "gemv_full": "gemvstep"}


def mesh_programs(meng, op: str, l: int) -> list:
    """The sharded programs that MeshCKKS built for op at level l (the gemv:
    every giant step's)."""
    head = MESH_HEADS[op]
    want = {"rot": 1, "conj": None}.get(op)
    return [p for k, p in meng._mesh_jit.items()
            if k[0] == head and k[1] == l and (head != "rot" or k[2] == want)]


def is_graph(p) -> bool:
    """Whether program p runs as CUDA graphs and has captured one: a mesh
    that cannot graph builds graphs.Program(graphed=False), run eagerly."""
    from gpqhe_tpu_torch.utils import graphs
    return isinstance(p, graphs.Program) and p.graphed and bool(p.graphs)


def mesh_graphed(meng, op: str, l: int) -> bool:
    """Whether op's sharded programs run as CUDA graphs (and have some)."""
    progs = mesh_programs(meng, op, l)
    return bool(progs) and all(is_graph(p) for p in progs)


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


# ---------------------------------------------------------------------------
# each engine program as a CUDA graph (utils/graphs.py) against the same
# program run eagerly under graphs.disabled()
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


# ---------------------------------------------------------------------------
# the rest of the JAX package's test suite
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


# ---------------------------------------------------------------------------
# K8 (csrc/ntt4.cu): the four-step ("matmul") NTT's stage
# ---------------------------------------------------------------------------

# the main path's transforms at logn=14 by chain, (mode, leading axes and
# primes): the butterfly path's shapes
NTT4_PATH = {logp: [(mode, shape[:-1]) for mode, shape in CASES[k] if shape[-1] == N14]
             for logp, k in ((59, "ntt"), (29, "ntt32"))}


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
