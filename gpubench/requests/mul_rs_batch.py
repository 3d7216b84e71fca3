"""Request kind mul_rs_batch: CKKS.mul_rs_batch of `batch` independent
ciphertext pairs at the top level, the pairs taken in turn from a pool of
fresh ciphertexts (HEBench's "Offline" category: a batch of independent
inputs at once)."""

from __future__ import annotations

from types import SimpleNamespace

from gpubench import port


def setup(cfg, traffic, inputs, seed, device):
    eng = port.engine(cfg, seed, device)
    sk = port.secret_key(eng, inputs["s"])
    rlk = eng.genrlk(sk)
    a = [port.encrypt(eng, sk, m) for m in inputs["m1"]]
    b = [port.encrypt(eng, sk, m) for m in inputs["m2"]]
    return SimpleNamespace(eng=eng, rlk=rlk, a=a, b=b, batch=traffic["batch"])


def call(st, i):
    j = (i * st.batch) % len(st.a)
    return st.eng.mul_rs_batch(st.a[j:j + st.batch], st.b[j:j + st.batch], st.rlk)


def sizes(st) -> dict:
    """The context's sizes of one product at the level the pool sits at."""
    ctx, l = st.eng.ctx, st.a[0].l
    return {"n": ctx.poly.n, "word": 32 if ctx.logp_prime < 30 else 64,
            "dim_mul": ctx.dim_mul(l), "dim_swk": ctx.dim_swk(l), "batch": st.batch}
