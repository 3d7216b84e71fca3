"""Request kind bootstrap: gpqhe_tpu_torch.bootstrap.bootstrap of one
ciphertext at a low level, which comes back with its levels refreshed; the
ciphertext taken in turn from a pool of fresh ciphertexts brought down to
that level in set-up."""

from __future__ import annotations

import time
from contextlib import contextmanager
from types import SimpleNamespace

import torch

from gpqhe_tpu_torch import bootstrap as bs

from gpubench import port

STAGES = ("raise_modulus", "subsum", "coeff2slot", "_exp_small_a", "slot2coeff")


def setup(cfg, traffic, inputs, seed, device):
    eng = port.engine(cfg, seed, device)
    sk = port.secret_key(eng, inputs["s"])
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(eng.ctx))
    bctx = bs.BootstrapContext(eng)
    pool = []
    for m in inputs["m"]:
        ct = port.encrypt(eng, sk, m)
        while ct.l > traffic["level_in"]:
            ct = eng.moddown(ct)
        pool.append(ct)
    return SimpleNamespace(eng=eng, rlk=rlk, ck=ck, rk=rk, bctx=bctx, pool=pool,
                           iter=cfg["bootstrap_iter"], min_level=traffic["min_level"])


def call(st, i):
    return [bs.bootstrap(st.eng, st.bctx, st.pool[i % len(st.pool)], st.rlk, st.ck, st.rk,
                         iter=st.iter)]


def check(st, outs):
    if outs[0].l < st.min_level:
        return f"came back at level {outs[0].l} < {st.min_level}"
    return None


@contextmanager
def _wrapped(wrap):
    """The bootstrap module's stage functions replaced by wrap(name, fn)
    for the block (bootstrap() finds them by their module names)."""
    saved = {name: getattr(bs, name) for name in STAGES}
    try:
        for name, fn in saved.items():
            setattr(bs, name, wrap(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(bs, name, fn)


def annotate(st):
    """Each stage a named host range in a profiler capture (no waiting)."""
    def wrap(name, fn):
        def named(*args, **kw):
            with torch.profiler.record_function("boot." + name):
                return fn(*args, **kw)
        return named
    return _wrapped(wrap)


def spans(st, first: int, reps: int = 2) -> dict:
    """Synchronised seconds of coeff2slot without its SubSum, and of EvalSin
    (both mod-reduce stages: from each exp's entry to the next stage), over
    `reps` requests (a copy of chip_smoke.py's StageClock)."""
    out = {"coeff2slot": [], "evalsin": []}
    for i in range(first, first + reps):
        marks = []

        def wrap(name, fn):
            def timed(*args, **kw):
                torch.cuda.synchronize()
                marks.append((name, "in", time.perf_counter()))
                r = fn(*args, **kw)
                torch.cuda.synchronize()
                marks.append((name, "out", time.perf_counter()))
                return r
            return timed
        with _wrapped(wrap):
            call(st, i)
        t = {}
        for name, edge, at in marks:
            t.setdefault((name, edge), []).append(at)

        def span(name):
            return t[name, "out"][0] - t[name, "in"][0]
        exp_in = t["_exp_small_a", "in"]
        out["coeff2slot"].append(span("coeff2slot") - span("subsum"))
        out["evalsin"].append(t["slot2coeff", "in"][0] - exp_in[0])
    return out
