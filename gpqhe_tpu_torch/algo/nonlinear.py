"""Homomorphic nonlinear functions: inv, sqrt, exp, log, sigmoid, comparison.

Ports of the reference's iterative/polynomial evaluators
(ref: src/he-algo.c:131-548).  Level bookkeeping (moddown placement) follows
the reference exactly; the engine asserts level equality at every mul, so any
divergence fails fast.
"""

from __future__ import annotations

import math

import numpy as np

from ..scheme.engine import CKKS
from ..scheme.types import Ciphertext, SwitchKey


def he_inv(eng: CKKS, ct: Ciphertext, rlk: SwitchKey, iter: int) -> Ciphertext:
    """Goldschmidt inverse, depth iter+1 (ref: src/he-algo.c:131-164)."""
    one = eng.const_pt(1)
    two = eng.const_pt(2)
    tmp = eng.neg(ct.copy())
    an = eng.moddown(eng.addpt(tmp, two))
    bn = eng.addpt(tmp, one)
    for _ in range(iter):
        bn = eng.rs(eng.mul(bn, bn, rlk))
        tmp = eng.addpt(bn, one)
        an = eng.rs(eng.mul(an, tmp, rlk))
    return an


def he_sqrt(eng: CKKS, ct: Ciphertext, rlk: SwitchKey, iter: int) -> Ciphertext:
    """Wilkes square-root iteration (ref: src/he-algo.c:166-206)."""
    one = eng.const_pt(1)
    three = eng.const_pt(3)
    half = eng.const_pt(0.5)
    quarter = eng.const_pt(0.25)
    an = ct.copy()
    bn = eng.subpt(ct, one)
    for _ in range(iter):
        tmp = eng.rs(eng.mulpt(bn, half))
        tmp = eng.neg(eng.subpt(tmp, one))          # 1 - bn/2
        an = eng.moddown(an)
        an = eng.rs(eng.mul(an, tmp, rlk))          # an *= (1 - bn/2)
        tmp = eng.subpt(bn, three)
        tmp = eng.rs(eng.mulpt(tmp, quarter))       # (bn-3)/4
        bn = eng.rs(eng.mul(bn, bn, rlk))
        bn = eng.rs(eng.mul(bn, tmp, rlk))          # bn^2 * (bn-3)/4
    return an


def he_sigmoid(eng: CKKS, ct: Ciphertext, rlk: SwitchKey) -> Ciphertext:
    """Degree-9 polynomial sigmoid (ref: src/he-algo.c:208-277)."""
    ct2 = eng.rs(eng.mul(ct, ct, rlk))
    ct4 = eng.rs(eng.mul(ct2, ct2, rlk))
    ct8 = eng.rs(eng.mul(ct4, ct4, rlk))
    ct3x = eng.rs(eng.mulpt(ct, eng.const_pt(-1.0 / 48)))
    ct13 = eng.addpt(ct2, eng.const_pt((1.0 / 4) / (-1.0 / 48)))
    ct13 = eng.rs(eng.mul(ct3x, ct13, rlk))
    ct13 = eng.moddown(eng.moddown(ct13))
    ct7x = eng.rs(eng.mulpt(ct, eng.const_pt(-17.0 / 80640)))
    ct57 = eng.addpt(ct2, eng.const_pt((1.0 / 480) / (-17.0 / 80640)))
    ct57 = eng.rs(eng.mul(ct7x, ct57, rlk))
    ct57 = eng.rs(eng.mul(ct4, ct57, rlk))
    ct57 = eng.moddown(ct57)
    ct9x = eng.rs(eng.mulpt(ct, eng.const_pt(31.0 / 1451520)))
    ct9x = eng.moddown(eng.moddown(ct9x))
    ct9x = eng.rs(eng.mul(ct9x, ct8, rlk))
    out = eng.add(ct13, ct57)
    out = eng.add(out, ct9x)
    return eng.addpt(out, eng.const_pt(0.5))


def he_log(eng: CKKS, ct: Ciphertext, rlk: SwitchKey) -> Ciphertext:
    """Degree-10 odd/even split log evaluator (ref: src/he-algo.c:279-361)."""
    ct2 = eng.rs(eng.mul(ct, ct, rlk))
    ct4 = eng.rs(eng.mul(ct2, ct2, rlk))
    ct8 = eng.rs(eng.mul(ct4, ct4, rlk))
    # odd part
    ctodd = ct8.copy()
    cttmp = eng.rs(eng.mulpt(ct2, eng.const_pt(9.0 / 7)))
    cttmp = eng.rs(eng.mul(cttmp, ct4, rlk))
    ctodd = eng.add(ctodd, cttmp)
    cttmp = eng.rs(eng.mulpt(ct4, eng.const_pt(9.0 / 5)))
    ctodd = eng.add(ctodd, cttmp)
    cttmp = eng.moddown(eng.rs(eng.mulpt(ct2, eng.const_pt(9.0 / 3))))
    ctodd = eng.add(ctodd, cttmp)
    ctodd = eng.addpt(ctodd, eng.const_pt(9))
    cttmp = eng.moddown(eng.moddown(eng.rs(eng.mulpt(ct, eng.const_pt(1.0 / 9)))))
    ctodd = eng.rs(eng.mul(cttmp, ctodd, rlk))
    # even part
    cteven = ct8.copy()
    cttmp = eng.rs(eng.mulpt(ct2, eng.const_pt(10.0 / 8)))
    cttmp = eng.rs(eng.mul(cttmp, ct4, rlk))
    cteven = eng.add(cteven, cttmp)
    cttmp = eng.rs(eng.mulpt(ct4, eng.const_pt(10.0 / 6)))
    cteven = eng.add(cteven, cttmp)
    cttmp = eng.moddown(eng.rs(eng.mulpt(ct2, eng.const_pt(10.0 / 4))))
    cteven = eng.add(cteven, cttmp)
    cteven = eng.addpt(cteven, eng.const_pt(10.0 / 2))
    cttmp = eng.moddown(eng.rs(eng.mulpt(ct2, eng.const_pt(-1.0 / 10))))
    cteven = eng.rs(eng.mul(cttmp, cteven, rlk))
    return eng.add(ctodd, cteven)


def _he_exp_taylor(eng: CKKS, ct: Ciphertext, rlk: SwitchKey) -> Ciphertext:
    """Taylor-to-x^7 via Paterson-Stockmeyer-ish grouping (ref: src/he-algo.c:364-432)."""
    ct2 = eng.rs(eng.mul(ct, ct, rlk))
    ct4 = eng.rs(eng.mul(ct2, ct2, rlk))
    one = eng.const_pt(1.0)
    ct01 = eng.addpt(ct, one)
    ct01 = eng.moddown(eng.rs(eng.mulpt(ct01, one)))
    ct23 = eng.addpt(ct, eng.const_pt(3.0))
    ct23 = eng.rs(eng.mulpt(ct23, eng.const_pt(1.0 / 6)))
    ct23 = eng.rs(eng.mul(ct2, ct23, rlk))
    ct0123 = eng.moddown(eng.add(ct01, ct23))
    ct45 = eng.addpt(ct, eng.const_pt(5.0))
    ct45 = eng.moddown(eng.rs(eng.mulpt(ct45, eng.const_pt(1.0 / 120))))
    ct67 = eng.addpt(ct, eng.const_pt(7.0))
    ct67 = eng.rs(eng.mulpt(ct67, eng.const_pt(1.0 / 5040)))
    ct67 = eng.rs(eng.mul(ct2, ct67, rlk))
    ct4567 = eng.add(ct45, ct67)
    ct4567 = eng.rs(eng.mul(ct4, ct4567, rlk))
    return eng.add(ct0123, ct4567)


def he_exp(eng: CKKS, a: complex, ct: Ciphertext, rlk: SwitchKey,
           iter: int) -> Ciphertext:
    """exp(a*ct): Taylor on a*ct/2^iter then iter squarings
    (ref: src/he-algo.c:435-458)."""
    slots = eng.ctx.slots
    a = complex(a) / (1 << iter)
    pt = eng.ecd(np.full(slots, a, dtype=np.complex128))
    act = eng.rs(eng.mulpt(ct, pt))
    out = _he_exp_taylor(eng, act, rlk)
    for _ in range(iter):
        out = eng.rs(eng.mul(out, out, rlk))
    return out


def _he_cmp_core(eng: CKKS, an: Ciphertext, ct: Ciphertext, rlk: SwitchKey,
                 iter: int, t: int) -> Ciphertext:
    """Iterated a^m/(a^m+b^m) comparison core (ref: src/he-algo.c:460-507)."""
    one = eng.const_pt(1)
    half = eng.const_pt(0.5)
    inv = eng.rs(eng.mulpt(an, half))
    inv = he_inv(eng, inv, rlk, iter)
    an = eng.rs(eng.mulpt(ct, half))
    for _ in range(iter + 1):
        an = eng.moddown(an)
    an = eng.rs(eng.mul(an, inv, rlk))
    bn = eng.neg(eng.subpt(an, one))
    for _ in range(t):
        an = eng.rs(eng.mul(an, an, rlk))
        bn = eng.rs(eng.mul(bn, bn, rlk))
        inv = eng.add(an, bn)
        inv = he_inv(eng, inv, rlk, iter)
        for _ in range(iter + 1):
            an = eng.moddown(an)
        an = eng.rs(eng.mul(an, inv, rlk))
        bn = eng.neg(eng.subpt(an, one))
    return an


def _cmp_t(alpha: int) -> int:
    c = 1 + 2.0 ** (-alpha)
    return int(math.log2(alpha / math.log2(c)))


def he_cmp(eng: CKKS, ct1: Ciphertext, ct2: Ciphertext, rlk: SwitchKey,
           iter: int, alpha: int) -> Ciphertext:
    """Approximate (ct1 > ct2), depth (3+iter)(1+t) (ref: src/he-algo.c:514-530)."""
    an = eng.add(ct1, ct2)
    return _he_cmp_core(eng, an, ct1, rlk, iter, _cmp_t(alpha))


def he_cmppt(eng: CKKS, ct: Ciphertext, pt, rlk: SwitchKey,
             iter: int, alpha: int) -> Ciphertext:
    """Approximate (ct > pt) (ref: src/he-algo.c:532-548)."""
    an = eng.addpt(ct, pt)
    return _he_cmp_core(eng, an, ct, rlk, iter, _cmp_t(alpha))
