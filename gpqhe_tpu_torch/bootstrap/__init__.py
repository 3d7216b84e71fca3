"""Bootstrapping: CoeffToSlot -> EvalSin -> SlotToCoeff, on the torch engine.

Port of gpqhe_tpu/bootstrap/__init__.py (only raise_modulus touches tensors;
the rest composes engine calls and carries over unchanged), itself a port of
the reference's he-bootstrap.c live path (ref: src/he-bootstrap.c:299-546):
dense U0/U1 DFT matrices from the 5^i cyclic roots, coeff2slot/slot2coeff as
gemv compositions, rlsin via exp/conj, and the full modulus-raise pipeline.

Fixes a latent reference bug: he_coeff2slot scales by he_const_pt(&pt, 1/n)
where 1/n is C INTEGER division == 0 for n > 1 (ref: src/he-bootstrap.c:385);
the correct scale 1.0/n is used here (SURVEY.md §3.5)."""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np

from .. import params
from ..algo.linalg import GemvPlan, HoistedGemvPlan, gemv
from ..algo.nonlinear import he_exp
from ..scheme.engine import CKKS
from ..scheme.types import Ciphertext, SwitchKey, limbs_to_torch
from ..ops import limbs as lb
from ..substrate import bigint


class BootstrapContext:
    """U-matrix bank + gemv plans.

    The reference builds U0[i,k] = zeta_{cyc[i*gap]}^{k*gap}
    (ref: src/he-bootstrap.c:299-342), which is only a valid DFT at FULL
    packing (slots = n/2); for sparse packing every row collapses to the
    same value (5^(4j) == 1 mod 16) and c2s degenerates — another untested
    corner of the reference.  The faithful generalization (verified exact,
    and equal to the reference's matrices at full packing):

        m' = 4*slots,  omega = e^(2 pi i / m'),  e_i = 5^i mod m'
        U0[i,k] = omega^(e_i k),   U1 = i * U0
        decode:  z = U0 (t0 + i t1)
        invert:  t0 = (U0^H z + U0^T conj(z)) / (2 slots),  same with U1
    """

    def __init__(self, eng: CKKS):
        ctx = eng.ctx
        slots = ctx.slots
        mp = 4 * slots
        om = np.exp(2j * params.PI / mp)
        U0 = np.array([[om ** ((pow(5, i, mp)) * k) for k in range(slots)]
                       for i in range(slots)], dtype=np.complex128)
        U1 = 1j * U0
        self.U0 = U0.reshape(-1)
        self.U1 = U1.reshape(-1)
        self.U0_T = U0.T.reshape(-1)
        self.U1_T = U1.T.reshape(-1)
        self.U0_conjT = np.conj(U0.T).reshape(-1)
        self.U1_conjT = np.conj(U1.T).reshape(-1)
        self.eng = eng
        self._plans: dict[str, GemvPlan] = {}  # hoisted when margin allows

    def plan(self, name: str) -> GemvPlan:
        if name not in self._plans:
            self._plans[name] = HoistedGemvPlan(self.eng, getattr(self, name))
        return self._plans[name]


def subsum_rotations(ctx) -> list[int]:
    """Rotation indices the SubSum trace ladder needs: slots * 2^j."""
    gap = (ctx.poly.n // 2) // ctx.slots
    return [ctx.slots << j for j in range(int(math.log2(gap)))]


def bootstrap_rotations(ctx) -> list[int]:
    """All rotation-key indices bootstrap uses: the BSGS gemv rotations
    [0, slots) plus the SubSum ladder.  Pass to CKKS.genrk."""
    return sorted(set(range(ctx.slots)) | set(subsum_rotations(ctx)))


def subsum(eng: CKKS, ct: Ciphertext, rk: dict[int, SwitchKey]) -> Ciphertext:
    """Trace projection onto the sparse-packing coefficient sublattice.

    At sparse packing (gap = n/(2*slots) > 1) a modulus-raised ciphertext
    carries q_src*I wrap terms at EVERY coefficient; the off-lattice ones are
    invisible to decode and to coeff2slot's slot view, but EvalSin's squarings
    fold (off-lattice)^2 back onto the lattice and destroy the message (the
    round-1 bootstrap failure).  Summing the gap Galois automorphisms
    sigma_{5^(slots*i)} (the subgroup fixing Z[X^gap] pointwise: 5^(slots*i)
    == 1 mod 4*slots) kills every off-lattice monomial (field trace of
    Q(zeta_2n)/Q(zeta_{4*slots})) and multiplies lattice coefficients by gap
    — the log2(gap)-step doubling ladder below is the standard HEAAN sparse
    bootstrapping SubSum.  This also explains the reference's (integer-
    division-bugged) 1/n normalizer in he_coeff2slot: 1/n = 1/(2*slots*gap)
    (ref: src/he-bootstrap.c:385-386); without SubSum the reference pipeline
    is only sound at full packing, and its end-to-end bootstrap test is a
    stub (ref: tests/gpqhe.c:1259-1275)."""
    ctx = eng.ctx
    gap = (ctx.poly.n // 2) // ctx.slots
    for j in range(int(math.log2(gap))):
        ct = eng.add(ct, eng.rot(ct.copy(), ctx.slots << j, rk))
    return ct


@contextmanager
def raised_delta(eng: CKKS, new_delta: float):
    """Temporarily raise the metadata scaling factor, like the reference's
    mutation of hectx.Delta (ref: src/he-bootstrap.c:510-516,543-545).
    The rescale SHIFT (by 2^logDelta) is unaffected — only encode scale and
    the nu ledger change.  ENGINE-scoped: the shared HeContext is never
    mutated (engines bound to the same context are unaffected)."""
    old = eng._delta_override
    eng._delta_override = float(new_delta)
    try:
        yield
    finally:
        eng._delta_override = old


def raise_modulus(eng: CKKS, ct: Ciphertext, nu: float | None = None) -> Ciphertext:
    """Reinterpret ct mod q_l as mod q_L: center the value mod q_l, then
    sign-extend into the top-level width (ref: src/he-bootstrap.c:513-516 —
    trivial there because coefficients are centered MPIs).

    The raised ciphertext decrypts to t = m*Delta + e + q_l*I with
    |I| <~ h/2 + 1 (hwt secret)."""
    ctx = eng.ctx
    logql = ctx.q[ct.l].bit_length() - 1
    kq = eng.kq
    ql_limbs = limbs_to_torch(bigint.int_to_limbs(ctx.q[ct.l], kq), eng.device)

    def fix(c):
        mbits = lb.mask_bits(lb.resize(c, kq), logql)
        hb_limb, hb_bit = divmod(logql - 1, 32)
        # a limb is a value below 2^32 held in int64: the shift needs no
        # unsigned emulation
        negmask = ((mbits[..., hb_limb] >> hb_bit) & 1) == 1
        wrapped = lb.sub(mbits, ql_limbs.expand(mbits.shape))
        return lb.mask_bits(lb.select(negmask, wrapped, mbits),
                            ctx.q[ctx.L].bit_length())
    return Ciphertext(l=ctx.L,
                      nu=float(ctx.q[ctx.L]) if nu is None else nu, B=ct.B,
                      c0=fix(ct.c0), c1=fix(ct.c1))


def coeff2slot(eng: CKKS, bctx: BootstrapContext, ct: Ciphertext,
               ck: SwitchKey, rk: dict[int, SwitchKey]) -> tuple[Ciphertext, Ciphertext]:
    """ct_real/imag = (U^dag ct' +- U^T conj(ct')) / n with ct' = SubSum(ct)
    (ref: src/he-bootstrap.c:358-408 — which writes integer 1/n == 0, a bug;
    the 1/n = 1/(2*slots*gap) normalizer absorbs SubSum's gap factor, see
    subsum()).  Valid for ANY input polynomial, including modulus-raised
    ciphertexts with full-support wrap terms.  At full packing (gap=1) the
    SubSum is empty and this reduces to the reference's construction.
    Requires rk to hold bootstrap_rotations(ctx)."""
    gap = (eng.ctx.poly.n // 2) // eng.ctx.slots
    ct = subsum(eng, ct, rk)
    pt = eng.const_pt(1.0 / (2 * eng.ctx.slots * gap))
    ct_conj = eng.conj(ct.copy(), ck)
    ct0 = gemv(eng, None, ct, rk, plan=bctx.plan("U0_conjT"), hoisted=True)
    ct1 = gemv(eng, None, ct_conj, rk, plan=bctx.plan("U0_T"), hoisted=True)
    ct_real = eng.rs(eng.mulpt(eng.add(ct0, ct1), pt))
    ct0 = gemv(eng, None, ct, rk, plan=bctx.plan("U1_conjT"), hoisted=True)
    ct1 = gemv(eng, None, ct_conj, rk, plan=bctx.plan("U1_T"), hoisted=True)
    ct_imag = eng.rs(eng.mulpt(eng.add(ct0, ct1), pt))
    return ct_real, ct_imag


def slot2coeff(eng: CKKS, bctx: BootstrapContext, ct0: Ciphertext,
               ct1: Ciphertext, rk: dict[int, SwitchKey]) -> Ciphertext:
    """ct = U0 ct0 + U1 ct1 (ref: src/he-bootstrap.c:414-437)."""
    u0 = gemv(eng, None, ct0, rk, plan=bctx.plan("U0"), hoisted=True)
    u1 = gemv(eng, None, ct1, rk, plan=bctx.plan("U1"), hoisted=True)
    return eng.add(u0, u1)


def rlsin(eng: CKKS, a: float, ct: Ciphertext, rlk: SwitchKey, ck: SwitchKey,
          iter: int) -> Ciphertext:
    """sin(a ct)/a = (e^{ia ct} - e^{-ia ct}) / (2ia) (ref: src/he-bootstrap.c:444-475)."""
    slots = eng.ctx.slots
    ct_exp = he_exp(eng, a * 1j, ct, rlk, iter)
    ct_exp_neg = eng.conj(ct_exp.copy(), ck)
    out = eng.sub(ct_exp, ct_exp_neg)
    b = 1.0 / (2j * a)
    pt = eng.ecd(np.full(slots, b, dtype=np.complex128))
    return eng.rs(eng.mulpt(out, pt))


def _exp_small_a(eng: CKKS, a: complex, ct: Ciphertext, rlk: SwitchKey,
                 iter: int) -> Ciphertext:
    """exp(a*mu) for |a| << 1/Delta: the constant a/2^iter is encoded at
    scale Delta^2 (it would round to 0 at Delta) and two rescales restore
    the running scale.  Mirrors he_exp otherwise (ref: src/he-algo.c:435-458)."""
    ctx = eng.ctx
    slots = ctx.slots
    av = complex(a) / (1 << iter)
    pt = eng.ecd(np.full(slots, av, dtype=np.complex128), nu=eng.Delta ** 2)
    act = eng.rs(eng.rs(eng.mulpt(ct, pt)))
    from ..algo.nonlinear import _he_exp_taylor
    out = _he_exp_taylor(eng, act, rlk)
    for _ in range(iter):
        out = eng.rs(eng.mul(out, out, rlk))
    return out


def min_bootstrap_iter(ctx) -> int:
    """Smallest EvalSin iteration count whose range condition holds:
    2^iter >= 4*pi*(h/2 + 1), h the (n/2-capped) secret Hamming weight —
    the modulus-raise wrap |I| <~ h/2 + 1 must land inside the Taylor
    window |2 pi t / q_src| / 2^iter <~ 0.5."""
    h_eff = min(params.BLKSIZ, ctx.poly.n // 2)
    return math.ceil(math.log2(4 * params.PI * (h_eff / 2 + 1)))


def bootstrap(eng: CKKS, bctx: BootstrapContext, ct: Ciphertext,
              rlk: SwitchKey, ck: SwitchKey, rk: dict[int, SwitchKey],
              iter: int | None = None) -> Ciphertext:
    """Full pipeline: raise -> c2s -> mod-reduction-by-sin -> s2c -> rs.

    Scale plan (DIVERGES from the reference, whose raise-Delta-to-qL flow
    overflows the ciphertext modulus with any nonzero message and is
    untested there, ref: src/he-bootstrap.c:477-546 + stub test at
    tests/gpqhe.c:1259-1275):

      - everything runs at the ordinary scale Delta; c2s puts the raw
        coefficients t_j = m_j*Delta + e + q_src*I_j into slots;
      - the mod-q_src reduction evaluates (q_src/2pi) sin(2pi t / q_src)
        via exp, with the tiny constant 2pi/(q_src 2^iter) encoded at
        Delta^2 (see _exp_small_a) and the huge constant q_src/(4pi i)
        encoded at Delta with norm-based dimension sizing;
      - needs |2pi t / q_src| / 2^iter <~ 0.5, i.e. 2^iter >~ 4pi(h/2+1) —
        VALIDATED here (iter=None derives the minimum from h);
      - consumes 10 + iter levels.
    """
    ctx = eng.ctx
    iter_min = min_bootstrap_iter(ctx)
    if iter is None:
        iter = iter_min
    elif iter < iter_min:
        raise ValueError(
            f"bootstrap iter={iter} violates the EvalSin range condition "
            f"2^iter >= 4*pi*(h/2+1) (h={min(params.BLKSIZ, ctx.poly.n // 2)} "
            f"needs iter >= {iter_min}); the result would be silent garbage. "
            "Pass iter=None to derive the minimum.")
    q_src = float(ctx.q[ct.l])
    if q_src / (4 * params.PI * eng.Delta) > 2.0 ** 8:
        import warnings
        warnings.warn(
            f"bootstrap: q_src/(4*pi*Delta) = "
            f"{q_src / (4 * params.PI * eng.Delta):.3g} is large; EvalSin's "
            "approximation error is amplified by this factor in message "
            "units and will likely swamp the payload (use a smaller base "
            "modulus q_0 or a larger Delta)", stacklevel=2)
    ct = raise_modulus(eng, ct, nu=eng.Delta)
    ct0, ct1 = coeff2slot(eng, bctx, ct, ck, rk)

    def mod_reduce(cti: Ciphertext) -> Ciphertext:
        # c2s output decodes to mu = t/Delta, so the exp argument constant is
        # a = 2 pi Delta / q_src, giving sin(a*mu) = sin(2 pi t / q_src).
        a = 2 * params.PI * eng.Delta / q_src
        ce = _exp_small_a(eng, a * 1j, cti, rlk, iter)
        ce_neg = eng.conj(ce.copy(), ck)
        diff = eng.sub(ce, ce_neg)           # 2i sin(2pi t / q_src)
        # divide by 2i and by (2 pi / q_src): output message ~ (t mod q_src)/Delta
        b = q_src / (4j * params.PI * eng.Delta)
        ptb = eng.ecd(np.full(ctx.slots, b, dtype=np.complex128))
        return eng.rs(eng.mulpt(diff, ptb))

    ct0 = mod_reduce(ct0)
    ct1 = mod_reduce(ct1)
    # After s2c the ciphertext already encodes m at scale Delta (the ledger
    # is consistent end-to-end) — no final rescale, unlike the reference's
    # (untested) flow which needed one to patch its scale mismatch.
    return slot2coeff(eng, bctx, ct0, ct1, rk)
