"""Request kind cmp: algo.nonlinear.he_cmp of two ciphertexts, the
configuration's iteration count and alpha, the pair taken in turn from a
pool of fresh ciphertexts."""

from __future__ import annotations

from types import SimpleNamespace

from gpqhe_tpu_torch.algo import nonlinear

from gpubench import port


def setup(cfg, traffic, inputs, seed, device):
    eng = port.engine(cfg, seed, device)
    sk = port.secret_key(eng, inputs["s"])
    rlk = eng.genrlk(sk)
    a = [port.encrypt(eng, sk, m) for m in inputs["a"]]
    b = [port.encrypt(eng, sk, m) for m in inputs["b"]]
    return SimpleNamespace(eng=eng, rlk=rlk, a=a, b=b, iter=cfg["cmp_iter"],
                           alpha=cfg["cmp_alpha"])


def call(st, i):
    j = i % len(st.a)
    return [nonlinear.he_cmp(st.eng, st.a[j], st.b[j], st.rlk, iter=st.iter, alpha=st.alpha)]
