"""Request kind gemv_sq: one encrypted linear layer with a square
activation, one ciphertext a request (HEBench's "Latency" category):
algo.linalg.gemv_hoisted_full by a slots x slots matrix whose plan is built
in set-up (rotation keys over range(slots)), then CKKS.mul_rs(y, y), then
CKKS.addpt of a bias plaintext encoded in set-up."""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from gpqhe_tpu_torch.algo import linalg

from gpubench import port


def setup(cfg, traffic, inputs, seed, device):
    eng = port.engine(cfg, seed, device)
    sk = port.secret_key(eng, inputs["s"])
    rlk = eng.genrlk(sk)
    rk = eng.genrk(sk, range(cfg["slots"]))
    plan = linalg.HoistedGemvPlan(eng, inputs["A"])
    pool = [port.encrypt(eng, sk, v) for v in inputs["v"]]
    st = SimpleNamespace(eng=eng, rlk=rlk, rk=rk, plan=plan, pool=pool, bias=None)
    y = linalg.gemv_hoisted_full(eng, plan, pool[0], rk)
    if y is None:
        raise RuntimeError("the hoisted gemv fell back: no margin for this configuration")
    # the bias at the scale that the square carries
    st.bias = eng.ecd(inputs["b"], nu=eng.mul_rs(y, y, rlk).nu)
    return st


def call(st, i):
    y = linalg.gemv_hoisted_full(st.eng, st.plan, st.pool[i % len(st.pool)], st.rk)
    if y is None:
        return [None]
    return [st.eng.addpt(st.eng.mul_rs(y, y, st.rlk), st.bias)]


def spans(st, first: int, reps: int = 8) -> dict:
    """Synchronised seconds of the gemv alone, over `reps` requests."""
    out = []
    for i in range(first, first + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        linalg.gemv_hoisted_full(st.eng, st.plan, st.pool[i % len(st.pool)], st.rk)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return {"gemv": out}
