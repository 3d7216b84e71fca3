"""The port against tests/test_kat.py's exact Python-integer oracle.

tests/torch_oracle.py carries a jax-free copy of that file's Oracle class;
the first test holds the copy's text equal to the original.  The port's
engine (plain CPU twin) then runs test_exact_oracle_kat's sequence at
logn=4/q=2^610/slots=2/Delta=2^30 and test_exact_oracle_ladder_sweep's at
logn=5 (L=20: conj and mul_rs at every level), each on the default 59-bit
chain and on the logp=29 chain, and every ciphertext must equal the
oracle's limb for limb (tolerance: none).  On the 59-bit chain at logn=4
every ciphertext of the sequence is also held bit-equal to the JAX
package's engine run from the same Surf() stream.
"""

import ast
import os

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.substrate.surf import Surf as JSurf

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy

from torch_oracle import (KAT_RING, LADDER_RING, Oracle, first_mismatch, kat_sequence,
                          ladder_sweep)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
KAT_CTS = ["enc_pk", "enc_sk", "add", "mul+relin", "rescale", "moddown", "conj", "rot1",
           "mul_rs"]


def _class_source(path: str, name: str) -> str:
    src = open(path).read()
    node = next(n for n in ast.parse(src).body if isinstance(n, ast.ClassDef) and n.name == name)
    return ast.get_source_segment(src, node)


def test_oracle_copy_is_the_original():
    assert (_class_source(os.path.join(HERE, "torch_oracle.py"), "Oracle")
            == _class_source(os.path.join(HERE, "test_kat.py"), "Oracle"))


def _against_oracle(ring: dict, logp: int, sequence):
    ctx = gt.HeContext(**ring, logp=logp)
    eng = gt.CKKS(ctx, rng=gt.Surf(), device="cpu")
    res = sequence(eng, Oracle(ctx))
    bad = {name: first_mismatch(eng, c, o) for name, c, o in res}
    assert not any(bad.values()), {k: v for k, v in bad.items() if v}
    return ctx, res


@pytest.mark.parametrize("logp", [59, 29])
def test_exact_oracle_kat(logp):
    _, res = _against_oracle(KAT_RING, logp, kat_sequence)
    assert [name for name, _, _ in res] == KAT_CTS


@pytest.mark.parametrize("logp", [59, 29])
def test_exact_oracle_ladder_sweep(logp):
    ctx, res = _against_oracle(LADDER_RING, logp, ladder_sweep)
    assert ctx.L >= 15, ctx.L
    assert len(res) == 1 + 2 * ctx.L and res[-1][1].l == 0


@pytest.fixture(scope="module")
def kat_both():
    jeng = gpqhe_tpu.CKKS(gpqhe_tpu.HeContext(**KAT_RING), rng=JSurf())
    teng = gt.CKKS(gt.HeContext(**KAT_RING), rng=gt.Surf(), device="cpu")
    return ({name: c for name, c, _ in kat_sequence(jeng, to_host=np.asarray)},
            {name: c for name, c, _ in kat_sequence(teng)})


@pytest.mark.parametrize("name", KAT_CTS)
def test_kat_bit_equal_to_jax(kat_both, name):
    j, t = kat_both[0][name], kat_both[1][name]
    assert (j.l, j.nu, j.B) == (t.l, t.nu, t.B)
    assert np.array_equal(np.asarray(j.c0), limbs_to_numpy(t.c0))
    assert np.array_equal(np.asarray(j.c1), limbs_to_numpy(t.c1))


@pytest.mark.slow
@pytest.mark.parametrize("case", ["kat", "ladder"])
def test_jax_engine_against_the_oracle_at_logp29(case):
    """The reference itself on the logp=29 chain, which test_kat.py does not
    run: the JAX engine's ciphertexts limb-equal to the oracle (~1 min for
    the KAT, ~6 min for the ladder's 40 programs on the CPU)."""
    ring, seq = (KAT_RING, kat_sequence) if case == "kat" else (LADDER_RING, ladder_sweep)
    eng = gpqhe_tpu.CKKS(gpqhe_tpu.HeContext(**ring, logp=29), rng=JSurf())
    res = seq(eng, Oracle(gt.HeContext(**ring, logp=29)), to_host=np.asarray)
    bad = {name: first_mismatch(eng, c, o, np.asarray) for name, c, o in res}
    assert not any(bad.values()), {k: v for k, v in bad.items() if v}
