"""Request kind mul_chain: a relinearized product at every level of a
circuit, one ciphertext a request: CKKS.mul_rs of the running ciphertext by
the second operand of its level, from level_in down to level_out, on one
output (the levels a bootstrap leaves spent on ciphertext-ciphertext
products; Jung et al., TCHES 2021(4), amortize one bootstrap over one such
product a level).  The first ciphertext is taken in turn from a pool of
fresh ciphertexts brought down to level_in in set-up; the second operands,
one a level, are made in set-up and shared by every request."""

from __future__ import annotations

from types import SimpleNamespace

from gpubench import port


def levels(traffic) -> list[int]:
    """The levels a request multiplies at, from level_in down to level_out + 1."""
    return list(range(traffic["level_in"], traffic["level_out"], -1))


def down(eng, ct, level: int):
    """ct taken down to `level` by moddown."""
    while ct.l > level:
        ct = eng.moddown(ct)
    return ct


def setup(cfg, traffic, inputs, seed, device):
    eng = port.engine(cfg, seed, device)
    sk = port.secret_key(eng, inputs["s"])
    rlk = eng.genrlk(sk)
    lv = levels(traffic)
    pool = [down(eng, port.encrypt(eng, sk, m), traffic["level_in"]) for m in inputs["x"]]
    w = {l: down(eng, port.encrypt(eng, sk, m), l) for l, m in zip(lv, inputs["w"])}
    return SimpleNamespace(eng=eng, rlk=rlk, pool=pool, w=w, levels=lv,
                           level_out=traffic["level_out"])


def call(st, i):
    ct = st.pool[i % len(st.pool)]
    for l in st.levels:
        ct = st.eng.mul_rs(ct, st.w[l], st.rlk)
    return [ct]


def check(st, outs):
    if outs[0].l != st.level_out:
        return f"ended at level {outs[0].l}, not {st.level_out}"
    return None
