"""Observability: context/plaintext/ciphertext pretty-printers.

Equivalent of the reference's he-info.c (ref: src/he-info.c:35-104): context
dump (moduli ladder, RNS primes, bounds) and per-object level/nu/B printers.
The analytically-tracked noise ledger (l, nu, B) is first-class metadata on
every ciphertext (SURVEY.md §5)."""

from __future__ import annotations

import math

from ..context import HeContext
from ..scheme.types import Ciphertext, Plaintext


def show_ctx_params(ctx: HeContext, out=print) -> None:
    """Full context dump (ref: src/he-info.c:35-79)."""
    p = ctx.poly
    out(f"n                 = {p.n} (logn={p.logn})")
    out(f"logq              = {p.logq} (upper bound {p.logqub})")
    out(f"slots             = {ctx.slots}")
    out(f"Delta             = 2^{ctx.p.bit_length() - 1}")
    out(f"L (max level)     = {ctx.L}")
    out(f"dim / dimevk / dimswk = {ctx.dim} / {ctx.dimevk} / {ctx.dimswk}")
    out(f"RNS primes (dimub={p.dimub}):")
    for i, pr in enumerate(p.primes):
        out(f"  p[{i:2d}] = {pr} ({pr.bit_length()} bits)")
    out("moduli ladder:")
    for l in range(ctx.L, -1, -1):
        out(f"  log q[{l}] = {ctx.q[l].bit_length() - 1}")
    b = ctx.bounds
    out(f"bounds: Bclean={b.Bclean:.6g} Brs={b.Brs:.6g} Bks={b.Bks:.6g}")
    for l in range(ctx.L + 1):
        out(f"  Bmult[{l}] = {b.Bmult[l]:.6g}")


def show_pt_params(ctx: HeContext, pt: Plaintext, title: str = "", out=print) -> None:
    """Plaintext summary (ref: src/he-info.c:81-92)."""
    out(f"[pt] {title}: nu={pt.nu:.6g} (log={math.log2(max(pt.nu, 1e-300)):.2f}) "
        f"limbs={pt.m.shape[-1]}")


def show_ct_params(ctx: HeContext, ct: Ciphertext, title: str = "", out=print) -> None:
    """Ciphertext summary (ref: src/he-info.c:94-104)."""
    logql = ctx.q[ct.l].bit_length() - 1
    out(f"[ct] {title}: l={ct.l} logq_l={logql} nu={ct.nu:.6g} "
        f"(log={math.log2(max(ct.nu, 1e-300)):.2f}) B={ct.B:.6g} "
        f"(log={math.log2(max(ct.B, 1e-300)):.2f})")
