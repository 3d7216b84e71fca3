"""The four-step NTT (ops/ntt4.py) against the JAX package's, and K8's
split and combine (csrc/ntt4.cu) through their numpy model.

  - make_ntt4_plan equals JAX's make_ntt4_plan table for table (the digit
    planes in the GEMM's layout: JAX's first P planes, its others zero);
  - ntt4, intt4 and intt4(scale_phatinv=True) bit-equal to JAX's ntt4,
    intt4 and RingEngine(ntt_impl="matmul").ntt_i(..., scale_phatinv=True),
    at logn 4-12, odd and even (n1 != n2), on the 59-bit chain, logp=29 and
    tests/test_crt_mode.py's logp=9 chain, with leading batch axes and rows
    of the edge words 0 and p - 1; the round trip;
  - the wrappers of ops/ntt4_cuda.py with the model of the kernels
    (tests/torch_ntt4_model.py) in place of the library: every step equal
    to the plain split and combine, every output word written once, on
    chip_smoke.py's K8 edge cases (the card runs the same ones, to logn=16)
    and at combine's largest digit sums for 1-4 planes; the wrappers'
    argument checks; the model's constants against ntt4.cu's.
JAX runs under jax.jit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import ntt4 as jntt4
from gpqhe_tpu.ring.poly import RingEngine as JRingEngine

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import cuda_build, ntt4_cuda
from gpqhe_tpu_torch.ops import ntt4 as tntt4
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch

import torch_ntt4_model as nm
from chip_smoke import CRT_CHAIN, ntt4_edge_cases, ntt4_input, ntt4_max_sums

torch.set_num_threads(1)

DIM = 3
# (logp, logn): every parity of logn on the 59-bit chain, both on logp=29,
# the logp=9 chain at its ring
RINGS = [(59, 4), (59, 5), (59, 8), (59, 11), (59, 12), (29, 6), (29, 7), (29, 12), (9, 4)]


def _ctx(pkg_ctx, logp, logn):
    if logp == 9:
        return pkg_ctx(logn, **CRT_CHAIN)
    return pkg_ctx(logn, q=1 << 20, logp=logp, dim_cap=8)


_CACHE = {}


def _rings(logp, logn):
    key = (logp, logn)
    if key not in _CACHE:
        jp, tp = _ctx(JPolyContext, logp, logn), _ctx(PolyContext, logp, logn)
        _CACHE[key] = (jp, tp, jntt4.make_ntt4_plan(jp, DIM), tntt4.make_ntt4_plan(tp, DIM))
    return _CACHE[key]


def _inputs(tp, logn, seed):
    """[2, 2, DIM, n] residues: random, then a row of 0 and a row of p - 1."""
    ps = np.array(tp.primes[:DIM], dtype=np.uint64)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 62, size=(2, 2, DIM, 1 << logn), dtype=np.uint64) % ps[:, None]
    x[0, 1] = 0
    x[1, 0] = ps[:, None] - np.uint64(1)
    return x


@pytest.mark.parametrize("logp,logn", RINGS)
def test_plan_equals_jax(logp, logn):
    _, _, jp, tp = _rings(logp, logn)
    assert (tp.n1, tp.n2, tp.dim) == (jp.n1, jp.n2, jp.dim)
    assert tp.planes == {59: 4, 29: 2, 9: 1}[logp]
    for k in ("ps", "pinv", "twid", "twist", "twid_i", "twist_i", "c_pow"):
        a, b = np.asarray(getattr(jp, k)), torch_to_u64(getattr(tp, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    for k in ("w1dig", "w2dig", "w1dig_i", "w2dig_i"):
        a = np.asarray(getattr(jp, k))
        m = a.shape[-1]
        b = getattr(tp, k).numpy().reshape(DIM, tp.planes, m, m)
        assert np.array_equal(a[:, :tp.planes], b) and not a[:, tp.planes:].any(), k


@pytest.mark.parametrize("logp,logn", RINGS)
def test_transforms_bit_equal_to_jax(logp, logn):
    jctx, tctx, jp, tp = _rings(logp, logn)
    x = _inputs(tctx, logn, seed=logn + logp)
    xt = u64_to_torch(x)
    jring = JRingEngine(jctx, ntt_impl="matmul")
    jring.prepare(DIM)
    want = {"fwd": jax.jit(lambda a: jntt4.ntt4(a, jp))(jnp.asarray(x)),
            "inv": jax.jit(lambda a: jntt4.intt4(a, jp))(jnp.asarray(x)),
            "inv_scaled": jax.jit(lambda a: jring.ntt_i(a, DIM, scale_phatinv=True))(
                jnp.asarray(x))}
    got = {"fwd": tntt4.ntt4(xt, tp), "inv": tntt4.intt4(xt, tp),
           "inv_scaled": tntt4.intt4(xt, tp, scale_phatinv=True)}
    for mode in want:
        assert np.array_equal(np.asarray(want[mode]), torch_to_u64(got[mode])), mode
    assert torch.equal(tntt4.intt4(got["fwd"], tp), xt)
    assert torch.equal(tntt4.ntt4(got["inv"], tp), xt)


@pytest.fixture
def model_lib(monkeypatch):
    """ops/ntt4_cuda.py's wrappers with the model in place of the library:
    CPU tensors pass the device check, the model reads their memory."""
    lib = nm.ModelLib()
    monkeypatch.setattr(ntt4_cuda, "_lib", lib)
    monkeypatch.setattr(cuda_build, "check_device", lambda *a: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda dev: 0)
    return lib


def _both(record):
    """split and combine that run the wrapper (the model) and the plain
    version on the same inputs, record whether they agree, and hand on the
    wrapper's output."""
    def split(*a):
        k, p = ntt4_cuda.split(*a), tntt4.plain_ntt4_split(*a)
        record.append(("split", torch.equal(k, p)))
        return k

    def combine(*a):
        k, p = ntt4_cuda.combine(*a), tntt4.plain_ntt4_combine(*a)
        record.append(("combine", torch.equal(k, p)))
        return k
    return split, combine


@pytest.mark.parametrize("case", ntt4_edge_cases(max_logn=10), ids=lambda c: c["id"])
def test_kernel_steps_equal_plain_at_the_edges(model_lib, case):
    pctx = PolyContext(case["logn"], **case["ctx"])
    plan = tntt4.make_ntt4_plan(pctx, case["dim"])
    x = ntt4_input(case, plan, "cpu")
    record = []
    inverse = case["mode"] != "fwd"
    scale = plan.phatinv if case["mode"] == "inv_scaled" else None
    got = tntt4.transform(x, plan, inverse, scale, *_both(record))
    want = (tntt4.plain_ntt4(x, plan) if not inverse
            else tntt4.plain_intt4(x, plan, scale is not None))
    assert [r[0] for r in record] == ["split", "combine"] * 2 and all(r[1] for r in record)
    assert torch.equal(got, want)
    assert len(model_lib.plans) == 4


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_combine_at_the_largest_digit_sums(model_lib, P):
    """Every product entry at 256 (2^16 - 1)^2 (k = 256): the anti-diagonal
    sums and their carries at their largest still fit the kernel's NL limbs
    (the model asserts it) and the result equals the plain version's."""
    _, _, _, tp = _rings(59, 8)
    args = ntt4_max_sums(tp, P, "cpu")
    assert torch.equal(ntt4_cuda.combine(*args), tntt4.plain_ntt4_combine(*args))


def test_kernel_transform_equals_plain(model_lib):
    _, tctx, _, tp = _rings(59, 11)
    xt = u64_to_torch(_inputs(tctx, 11, seed=3))
    assert torch.equal(tntt4.kernel_ntt4(xt, tp), tntt4.plain_ntt4(xt, tp))
    assert torch.equal(tntt4.kernel_intt4(xt, tp, True), tntt4.plain_intt4(xt, tp, True))
    steps = [p[:1] + p[6:] for p in model_lib.plans]
    # forward: pre-twist split, twiddle combine, transposing split, bare combine
    assert steps[:4] == [("split", False, True), ("combine", True, False),
                         ("split", True, False), ("combine", False, False)]
    # inverse: bare split and combine, transposing twiddle split, untwist and scale
    assert steps[4:] == [("split", False, False), ("combine", False, False),
                         ("split", True, True), ("combine", True, True)]


def test_wrapper_checks(model_lib):
    _, tctx, _, tp = _rings(59, 8)
    x = u64_to_torch(_inputs(tctx, 8, seed=5))
    with pytest.raises(ValueError, match="split takes"):
        ntt4_cuda.split(x[..., :128], tp, 16, 16, False, None)
    with pytest.raises(ValueError, match="contiguous table"):
        ntt4_cuda.split(x, tp, 16, 16, False, tp.twist[:, ::2])
    with pytest.raises(ValueError, match="int64"):
        ntt4_cuda.split(x.to(torch.int32), tp, 16, 16, False, None)
    y = torch.bmm(tp.w1dig, ntt4_cuda.split(x, tp, 16, 16, False, None))
    assert ntt4_cuda.combine(y, tp, (2, 2), 16, 16, None, None).shape == x.shape
    with pytest.raises(ValueError, match="combine takes"):
        ntt4_cuda.combine(y, tp, (3,), 16, 16, None, None)
    with pytest.raises(ValueError, match="f64|float64"):
        ntt4_cuda.combine(y.to(torch.float32), tp, (2, 2), 16, 16, None, None)
    _, _, _, tp4 = _rings(59, 4)
    big = torch.zeros((22000, DIM, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="slabs"):
        ntt4_cuda.split(big, tp4, 4, 4, False, None)
    _, tctx12, _, _ = _rings(59, 12)
    wide = tntt4.make_ntt4_plan(tctx12, 1)
    with pytest.raises(ValueError, match="contraction of 512"):
        ntt4_cuda.split(torch.zeros((1, 1, 1 << 12), dtype=torch.int64), wide, 8, 512, True,
                        None)


def test_cpu_tensors_never_reach_the_kernels():
    """Without the model the wrappers refuse a CPU tensor; ntt4/intt4 take
    the plain versions for it."""
    _, tctx, _, tp = _rings(59, 5)
    x = u64_to_torch(_inputs(tctx, 5, seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        ntt4_cuda.split(x, tp, 4, 8, False, None)
    before = dict(ntt4_cuda.LAUNCHES)
    tntt4.ntt4(x, tp)
    assert ntt4_cuda.LAUNCHES == before


def test_model_constants_match_the_source():
    src = open(ntt4_cuda.SOURCE).read()
    defs = dict(re.findall(r"^#define (\w+) (\d+)", src, flags=re.M))
    assert int(defs["SPLIT_TILE"]) == nm.SPLIT_TILE
    assert int(defs["SPLIT_ROWS"]) == nm.SPLIT_ROWS
    assert int(defs["COMBINE_THREADS"]) == nm.COMBINE_THREADS
    assert "(16 * (2 * P - 2) + 106) / 64" in src
    assert all(nm.limbs_of(P) == tntt4.limbs_of(P) for P in range(1, 5))
    assert ntt4_cuda.GRID_Y == nm.GRID_Y
