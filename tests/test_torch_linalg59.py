"""The port's algo/linalg.py against the JAX package's on the default 59-bit
chain, at logn=9/logq=120/slots=4/Delta=2^30 (see test_torch_linalg.py,
which holds the checks and runs them on the logp=29 chain).
"""

import json
import os

import numpy as np
import pytest
import torch

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.algo import linalg as tlin
from gpqhe_tpu_torch.ring import sample as tsmp

from test_torch_linalg import ALL, both_runs, check_bit_equal, check_routes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return both_runs("logp59")


@pytest.mark.parametrize("name", ALL)
def test_linalg_bit_equal_59bit_chain(runs, name):
    check_bit_equal(runs, name)


def test_routes_taken_59bit_chain(runs):
    check_routes(runs)


@pytest.mark.slow
def test_golden_algo_linear_on_the_port():
    """tests/test_golden_algo.py's linear KAT (the reference binary's gemv,
    sum, idx, nrm2 at logn=14/logq=438/slots=16/Delta=2^50) replayed on the
    port, within the same 1e-9 gate."""
    path = os.path.join(os.path.dirname(__file__), "golden", "golden_algo_linear.json")
    with open(path) as f:
        g = {k: np.array([complex(a, b) for a, b in v]) for k, v in json.load(f).items()}
    ctx = gt.HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50)
    eng = gt.CKKS(ctx, rng=gt.Surf(), device="cpu")
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    v = tsmp.sample_z01vec(eng.rng, ctx.slots)
    A = tsmp.sample_z01vec(eng.rng, ctx.slots * ctx.slots)
    assert np.array_equal(v, g["v"]) and np.array_equal(A, g["A"])
    ct = eng.enc_pk(eng.ecd(v), pk)

    def dec(out):
        return eng.dcd(eng.dec(out, sk))
    plan = tlin.HoistedGemvPlan(eng, A)
    assert np.max(np.abs(dec(tlin.gemv(eng, None, ct, rk, plan=plan, hoisted=True))
                         - g["gemv"])) < 1e-9
    assert plan.fallbacks == 0
    assert np.max(np.abs(dec(tlin.he_sum(eng, ct, rk, hoisted=True)) - g["sum"])) < 1e-9
    assert np.max(np.abs(dec(tlin.he_idx(eng, ct, 1, rk, hoisted=True)) - g["idx1"])) < 1e-9
    assert np.max(np.abs(dec(tlin.he_nrm2(eng, ct, rlk, ck, rk)) - g["nrm2"])) < 1e-9
