"""Homomorphic linear algebra: BSGS gemv, sum, idx, nrm2, on the torch engine.

Port of gpqhe_tpu/algo/linalg.py, itself a port of the reference's
he-algo.c linear-transform layer (ref: src/he-algo.c:29-124).  These
compose only public scheme ops — a clean "client program" layer.

Difference from the reference: the rotated-diagonal plaintexts of a given
matrix are encoded once per (matrix, call) and reusable via `GemvPlan`
(the reference re-encodes every diagonal on every call,
ref: src/he-algo.c:70-73 — SURVEY.md §7.5 hoisting).

Each matrix-vector product is one span linalg.gemv of the op trace and the
profiler (utils/trace.py), whichever route it takes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..scheme.engine import CKKS
from ..scheme.types import Ciphertext, Plaintext, SwitchKey
from ..utils import trace


def zrotdiag(A: np.ndarray, idx: int, rot: int, m: int) -> np.ndarray:
    """Rotated generalized diagonal of the slots x slots matrix A
    (ref: src/he-algo.c:29-43)."""
    i = np.arange(m)
    diag = A[(i % m) * m + (idx + i) % m]
    rotidx = (i + rot) % m
    return diag[rotidx]


class GemvPlan:
    """Pre-encoded diagonals of one matrix for repeated gemv calls."""

    def __init__(self, eng: CKKS, A: np.ndarray):
        slots = eng.ctx.slots
        A = np.asarray(A, dtype=np.complex128).reshape(-1)
        assert A.shape[0] == slots * slots
        n1 = int(math.isqrt(slots))
        if n1 * n1 != slots:
            n1 = int(math.isqrt(2 * slots))
        self.n1 = n1                      # giant step (ref: src/he-algo.c:51-53)
        self.n2 = slots // n1             # baby step
        self.pts: dict[tuple[int, int], Plaintext] = {}
        for i in range(self.n2):
            shift = i * self.n1
            for j in range(self.n1):
                rd = zrotdiag(A, shift + j, -shift, slots)
                self.pts[(i, j)] = eng.ecd(rd)


def gemv(eng: CKKS, A, ct: Ciphertext, rk: dict[int, SwitchKey],
         plan: GemvPlan | None = None, hoisted: bool = False) -> Ciphertext:
    """BSGS matrix-vector product (ref: src/he-algo.c:47-93).

    hoisted=True uses double-hoisted rotations (one key switch per giant
    step instead of per baby step — CKKS.hoisted_gemv_step_fn)."""
    if hoisted:
        if isinstance(plan, HoistedGemvPlan):
            hplan = plan
        elif A is None:
            raise ValueError(
                "gemv(hoisted=True) needs a HoistedGemvPlan when A is None "
                "(a plain GemvPlan cannot be used; rebuild with "
                "HoistedGemvPlan(eng, A))")
        else:
            hplan = HoistedGemvPlan(eng, A)
        return gemv_hoisted(eng, hplan, ct, rk)
    if plan is None:
        plan = GemvPlan(eng, A)
    with trace.span("linalg.gemv", eng.device):
        outer = None
        for i in range(plan.n2):
            shift = i * plan.n1
            inner = None
            for j in range(plan.n1):
                ct_rot = eng.rot(ct.copy(), j, rk)
                ct_rot = eng.mulpt(ct_rot, plan.pts[(i, j)])
                inner = ct_rot if inner is None else eng.add(inner, ct_rot)
            inner = eng.rot(inner, shift, rk)
            outer = inner if outer is None else eng.add(outer, inner)
        return eng.rs(outer)


class HoistedGemvPlan(GemvPlan):
    """GemvPlan with per-level pre-NTT'd diagonal packs for hoisted gemv."""

    def __init__(self, eng: CKKS, A: np.ndarray):
        super().__init__(eng, A)
        self._A = np.asarray(A, dtype=np.complex128).reshape(-1)
        self._packs: dict[int, tuple] = {}
        self._rk_stacks: dict[int, tuple] = {}
        self._pts_full: dict[int, Plaintext] | None = None
        self.fallbacks = 0   # times gemv_hoisted dropped to the classic path

    # -- FULL hoisting: all `slots` rotations from the one decomposition ----

    def pts_full(self, eng: CKKS) -> dict[int, Plaintext]:
        """Unrotated diagonals diag_r = zrotdiag(A, r, 0): the plaintext of
        rotation r in the fully-hoisted sum out = sum_r diag_r * rot_r(ct)
        (identical math to the BSGS split with the outer rotation pulled
        inside the plaintext encoding)."""
        if self._pts_full is None:
            slots = eng.ctx.slots
            self._pts_full = {
                r: eng.ecd(zrotdiag(self._A, r, 0, slots))
                for r in range(slots)}
        return self._pts_full

    def bound_max_full(self, eng: CKKS) -> float:
        return max(pt.size_bound for pt in self.pts_full(eng).values())

    def pack_full(self, eng: CKKS, l: int, dims: tuple[int, int]):
        """(ptx [slots, dims_h, n], ptb [slots, dimc, n]) pre-NTT'd full-
        hoist diagonal tables, cached per (level, dims)."""
        key = ("full", l, dims)
        if key not in self._packs:
            pts = self.pts_full(eng)
            dims_h, dimc = dims

            def tab(dim):
                return torch.stack([
                    eng.ring.fwd_ntt(pts[r].m, dim,
                                     signed_bits=pts[r].mod_bits)
                    for r in range(eng.ctx.slots)])
            self._packs[key] = (tab(dims_h), tab(dimc))
        return self._packs[key]

    def rk_stack_full(self, eng: CKKS, rk: dict[int, SwitchKey]):
        keys = tuple(rk[r] for r in range(eng.ctx.slots))
        key = ("full",) + tuple(id(k) for k in keys)
        if key not in self._rk_stacks:
            self._rk_stacks[key] = (
                keys,
                torch.stack([k.p0hat for k in keys]),
                torch.stack([k.p1hat for k in keys]))
        return self._rk_stacks[key][1:]

    def bound_max(self) -> float:
        """Basis-sizing coefficient bound over all diagonals (size_bound, not
        nu: encoded coefficients can exceed nu for messages > 1 — mirroring
        mulpt's dim_mulpt(l, pt.size_bound) sizing)."""
        return max(pt.size_bound for pt in self.pts.values())

    def dims(self, eng: CKKS, l: int):
        """(dims_h, dimc, nu_max) for level l (via eng.gemv_dims)."""
        nu_max = max(pt.nu for pt in self.pts.values())
        dims_h, dimc = eng.gemv_dims(l, self.bound_max() * self.n1)
        return dims_h, dimc, nu_max

    def pack_slab(self, eng: CKKS, l: int, i: int,
                  dims: tuple[int, int] | None = None):
        """(ptx_i [n1, dims_h, n], ptb_i [n1, dimc, n]) — the pre-NTT'd
        diagonal plaintexts of giant step i at level l, built lazily so
        peak memory during a streamed gemv is one slab, and cached for plan
        reuse.  dims overrides (dims_h, dimc) (any dims >= the formulas are
        valid CRT ranges)."""
        key = (l, i, dims)
        if key not in self._packs:
            if dims is None:
                dims_h, dimc, _ = self.dims(eng, l)
            else:
                dims_h, dimc = dims

            def tab(dim):
                return torch.stack([
                    eng.ring.fwd_ntt(self.pts[(i, j)].m, dim,
                                     signed_bits=self.pts[(i, j)].mod_bits)
                    for j in range(self.n1)])
            self._packs[key] = (tab(dims_h), tab(dimc))
        return self._packs[key]

    def rk_stack(self, rk: dict[int, SwitchKey]):
        # key on the SwitchKey objects (not the dict container, whose id can
        # be reused after GC) and hold strong refs so the ids stay valid
        keys = tuple(rk[j] for j in range(self.n1))
        key = tuple(id(k) for k in keys)
        if key not in self._rk_stacks:
            self._rk_stacks[key] = (
                keys,
                torch.stack([k.p0hat for k in keys]),
                torch.stack([k.p1hat for k in keys]))
        return self._rk_stacks[key][1:]


def gemv_hoisted_full(eng: CKKS, plan: HoistedGemvPlan, ct: Ciphertext,
                      rk: dict[int, SwitchKey]) -> Ciphertext | None:
    """FULLY-hoisted gemv: ALL `slots` rotations ride the single
    decomposition+NTT of ct (one batched product over slots baby steps, ONE
    divide-round total, no outer rotations, no adds) — out =
    sum_r diag_r * rot_r(ct), then rescale.

    The double-hoisted BSGS path pays n2 giant steps + n2-1 OUTER ROTATIONS,
    each outer rot a full key switch.  When the rotation-key bank covers
    range(slots) (the reference generates exactly that bank,
    ref: src/he-kem.c:154-169) the BSGS split only saves key MEMORY, which
    hoisting already made moot; collapsing to the plain diagonal method
    removes the n2-1 outer key switches entirely.  The accumulation bound
    grows from n1 to slots products (bits_hoist absorbs it; margin checked
    below).  Returns None when the bank or the hoisting margin does not
    cover (caller falls back to the BSGS path).  Device memory: the rk
    stack and diagonal pack are [slots, dim, n] — fine for the reference's
    slot counts; at slots >> 2^10 prefer the BSGS path."""
    ctx = eng.ctx
    l = ct.l
    slots = ctx.slots
    if any(r not in rk for r in range(slots)):
        return None
    bnd_sum = plan.bound_max_full(eng) * slots
    dims_h, dimc = eng.gemv_dims(l, bnd_sum)
    if dims_h > eng.dimswk_h or eng.ring.ntt_impl == "matmul":
        return None
    with trace.span("linalg.gemv", eng.device):
        pts = plan.pts_full(eng)
        nu_max = max(pt.nu for pt in pts.values())
        prep = eng.hoisted_gemv_prep_fn(l, slots, dims_h, dimc)
        step = eng.hoisted_gemv_step_fn(
            l, dims_h, dimc,
            bits_h=eng.bits_hoist(l, bnd_sum),
            bits_c=ctx.bits_mulpt(l, bnd_sum))
        c1p, c0p = prep(ct.c0, ct.c1)
        rk0, rk1 = plan.rk_stack_full(eng, rk)
        ptx, ptb = plan.pack_full(eng, l, (dims_h, dimc))
        out0, out1 = step(c1p, c0p, ptx, ptb, rk0, rk1)
        out = Ciphertext(l=l, nu=ct.nu * nu_max, B=slots * ct.B * nu_max,
                         c0=out0, c1=out1)
        return eng.rs(out)


def gemv_hoisted(eng: CKKS, plan: HoistedGemvPlan, ct: Ciphertext,
                 rk: dict[int, SwitchKey]) -> Ciphertext:
    """Hoisted gemv: fully-hoisted when the key bank and margin allow
    (gemv_hoisted_full), else double-hoisted BSGS (one key switch per
    giant step).

    Streams one plaintext slab per giant step through one step program, so
    device memory stays flat as slots grow."""
    full = gemv_hoisted_full(eng, plan, ct, rk)
    if full is not None:
        return full
    l = ct.l
    if (eng.gemv_dims(l, plan.bound_max() * plan.n1)[0] > eng.dimswk_h
            or eng.ring.ntt_impl == "matmul"):
        # plaintext scale exceeds the switch-key hoisting margin (or the
        # backend's NTT ordering has no permutation tables) — classic path.
        # This is a LARGE perf cliff (n1 key switches per giant step instead
        # of 1), so it is loud: one warning + a counter on the plan.
        import warnings
        plan.fallbacks += 1
        warnings.warn(
            f"hoisted gemv falling back to the classic path at level {l} "
            f"(dim_hoist={eng.dim_hoist(l, plan.bound_max() * plan.n1)} > "
            f"dimswk_h={eng.dimswk_h} or ntt_impl={eng.ring.ntt_impl!r}); "
            "raise hoist_bits at engine construction to keep hoisting",
            stacklevel=2)
        return gemv(eng, None, ct, rk, plan=plan)
    dims_h, dimc, nu_max = plan.dims(eng, l)
    bnd_sum = plan.bound_max() * plan.n1
    with trace.span("linalg.gemv", eng.device):
        rk0, rk1 = plan.rk_stack(rk)
        prep = eng.hoisted_gemv_prep_fn(l, plan.n1, dims_h, dimc)
        step = eng.hoisted_gemv_step_fn(
            l, dims_h, dimc,
            bits_h=eng.bits_hoist(l, bnd_sum),
            bits_c=eng.ctx.bits_mulpt(l, bnd_sum))
        c1p, c0p = prep(ct.c0, ct.c1)
        # ledger mirrors the classic composition: mulpt (nu*=, B*=) then adds
        nu_i = ct.nu * nu_max
        B_i = plan.n1 * ct.B * nu_max
        outer = None
        for i in range(plan.n2):
            ptx_i, ptb_i = plan.pack_slab(eng, l, i)
            out0, out1 = step(c1p, c0p, ptx_i, ptb_i, rk0, rk1)
            inner = Ciphertext(l=l, nu=nu_i, B=B_i, c0=out0, c1=out1)
            if i:
                inner = eng.rot(inner, i * plan.n1, rk)
            outer = inner if outer is None else eng.add(outer, inner)
        return eng.rs(outer)


def he_sum(eng: CKKS, ct: Ciphertext, rk: dict[int, SwitchKey],
           hoisted: bool = False) -> Ciphertext:
    """Sum of slots into slot row 0 (ref: src/he-algo.c:95-103)."""
    slots = eng.ctx.slots
    A = np.zeros(slots * slots, dtype=np.complex128)
    A[:slots] = 1
    return gemv(eng, A, ct, rk, hoisted=hoisted)


def he_idx(eng: CKKS, ct: Ciphertext, idx: int, rk: dict[int, SwitchKey],
           hoisted: bool = False) -> Ciphertext:
    """Extract slot idx (ref: src/he-algo.c:105-112)."""
    slots = eng.ctx.slots
    A = np.zeros(slots * slots, dtype=np.complex128)
    A[idx * slots + idx] = 1
    return gemv(eng, A, ct, rk, hoisted=hoisted)


def he_nrm2(eng: CKKS, ct: Ciphertext, rlk: SwitchKey, ck: SwitchKey,
            rk: dict[int, SwitchKey]) -> Ciphertext:
    """Squared 2-norm: sum(ct * conj(ct)) (ref: src/he-algo.c:114-124)."""
    ct_conj = eng.conj(ct.copy(), ck)
    out = eng.rs(eng.mul(ct, ct_conj, rlk))
    return he_sum(eng, out, rk)
