"""K5's elementwise kernel (csrc/modmath.cu mm_ew_kernel) without a card:
the numpy model of the kernel (tests/torch_modmath_model.py) against the
plain torch versions and the JAX package's functions.

  - the arithmetic as the kernel runs it (mulmod by one Barrett reduction
    against the wrapper's per-prime table; mont.cuh's Montgomery product,
    addmod, submod), every precondition asserted on every word, on
    the logp=9, 29 and 59 chains' primes, mont_mul also on any u64 words,
    against ops/modmath.py's plain versions (mulmod: two Montgomery
    products) and gpqhe_tpu/ops/modmath.py under jax.jit;
  - the launch's work split (threads a block, 16-byte pairs, the pair,
    constant and word paths of each operand row, tails, the loop over A past
    the grid): every output word written once, through ops/modmath_cuda.py's
    wrapper as it calls the library, on torch_cases.py's edge cases (the card
    runs the same ones);
  - the model's constants against modmath.cu's #defines.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpqhe_tpu.ops import modmath as jm
from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import cuda_build, modmath_cuda
from gpqhe_tpu_torch.ops import modmath as tm
from gpqhe_tpu_torch.ops import rns as tr

import torch_modmath_model as mm
from torch_cases import CRT_CHAIN, ew_compare, modmath_edge_cases

torch.set_num_threads(1)

U = np.uint64
CHAINS = {59: PolyContext(6, q=1 << 20, dim_cap=24),
          29: PolyContext(6, q=1 << 20, logp=29, dim_cap=24),
          9: PolyContext(4, **CRT_CHAIN)}
OPS = {"mont_mul": mm.OP_MONT_MUL, "mulmod": mm.OP_MULMOD, "addmod": mm.OP_ADDMOD,
       "submod": mm.OP_SUBMOD}


def _defines(path):
    return {m[0]: int(m[1]) for m in
            re.findall(r"^#define (\w+) (\d+)", open(path).read(), flags=re.M)}


def test_modmath_constants_mirror_the_source():
    d = _defines(modmath_cuda.SOURCE)
    for name in ("EW_THREADS", "EW_PAIRS"):
        assert d[name] == getattr(mm, name), name
    assert mm.EW_WORDS == 2 * mm.EW_PAIRS and mm.EW_THREADS % 32 == 0
    assert modmath_cuda.OP == {"mont_mul": 0, "to_mont": 0, "mulmod": 1, "addmod": 2,
                               "submod": 3}


def _words(rng, shape):
    """Any u64 words, the edges 0, 2^63 and 2^64 - 1 first along the last axis."""
    x = rng.integers(0, 1 << 64, size=shape, dtype=U, endpoint=False)
    x[..., :3] = np.array([0, 1 << 63, (1 << 64) - 1], dtype=U)
    return x


def _residues(rng, p, shape):
    x = rng.integers(0, 1 << 63, size=shape, dtype=U) % p
    x[..., :3] = np.concatenate([np.zeros_like(p), np.ones_like(p), p - U(1)], axis=-1)
    return x


def _j(fn, *args):
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("logp", [59, 29, 9])
@pytest.mark.parametrize("op", ["mont_mul", "mont_mul_words", "mulmod", "addmod", "submod"])
def test_ew_arithmetic_against_plain_and_jax(op, logp):
    """The model's per-word arithmetic equals the plain version and the JAX
    package's function bit for bit, on residues with the edge words and
    (mont_mul_words) any u64 words against residues; mulmod is x y mod p;
    the model asserts hi < p at every reduction and a, b < p for add and
    sub."""
    pctx = CHAINS[logp]
    dim = min(6, len(pctx.primes))
    b = pctx.basis(dim)
    p = np.asarray(pctx.primes[:dim], dtype=U)[:, None]
    pinv = np.asarray(b.pinv_mont, dtype=U)[:, None]
    r2 = np.asarray(b.r2, dtype=U)[:, None]
    rng = np.random.default_rng(logp * 7 + len(op))
    n = 256
    y = _residues(rng, p, (dim, n))[:, ::-1].copy()
    x = _words(rng, (dim, n)) if op == "mont_mul_words" else _residues(rng, p, (dim, n))
    name = op.split("_words")[0]
    got = mm.ew_op(OPS[name], x, y, p, pinv, mm.barrett_mu(p))
    t = [torch.from_numpy(a.view(np.int64)) for a in (x, y, p, pinv, r2)]
    plain = getattr(tm, f"plain_{name}")(*t[:2], *t[2:{"mulmod": 5, "mont_mul": 4}.get(name, 3)])
    jfn = {"mont_mul": jm.mont_mul, "mulmod": jm.mulmod, "addmod": jm.addmod,
           "submod": jm.submod}[name]
    jargs = (x, y, p, pinv, r2)[:{"mulmod": 5, "mont_mul": 4}.get(name, 3)]
    assert np.array_equal(got, plain.numpy().view(U))
    assert np.array_equal(got, _j(jfn, *jargs))
    if name == "mulmod":
        assert np.array_equal(got.astype(object), x.astype(object) * y.astype(object) % p)
    assert (got < p).all()


def test_ew_reductions_at_their_extremes():
    """mont_mul's reduction is exact for any u64 a against b < p (the high
    word of (2^64 - 1)(p - 1) is below p), and mulmod's Barrett reduction
    for a, b < p (p < 2^62, so 3p fits a word): on the smallest and the
    largest primes of the three chains, at (p - 1)^2 and its neighbours."""
    for pctx in CHAINS.values():
        dim = min(6, len(pctx.primes))
        b = pctx.basis(dim)
        for i in (0, dim - 1):
            p = pctx.primes[i]
            assert ((2**64 - 1) * (p - 1)) >> 64 < p and p < 1 << 62
            pu, pinv, r2 = (np.array([v], dtype=U) for v in (p, b.pinv_mont[i], b.r2[i]))
            assert mm.mont_mul(np.array([(1 << 64) - 1], dtype=U), pu - U(1), pu, pinv) < pu
            a = np.array([p - 1, p - 1, p - 2, 1, 0, p // 2], dtype=U)
            c = np.array([p - 1, p - 2, p - 2, p - 1, p - 1, p // 2 + 1], dtype=U)
            got = mm.barrett_mulmod(a, c, pu, mm.barrett_mu(pu))
            assert [int(v) for v in got] == [int(x) * int(y) % p for x, y in zip(a, c)]


@pytest.mark.parametrize("logp", [59, 29, 9])
def test_barrett_table_once_per_basis(logp):
    """The wrapper's table of mulmod's constant: floor(2^(k+63) / p) for
    every prime of the chain, through any view of the primes (the [dim, 1]
    the callers pass, a slice, a broadcast prime); built once per table
    and view, then the same tensor."""
    pctx = CHAINS[logp]
    dim = min(24, len(pctx.primes))
    ps = tr.make_basis_arrays(pctx, dim, "cpu").ps
    want = [(1 << (q.bit_length() + 63)) // q for q in pctx.primes[:dim]]
    mu = modmath_cuda.barrett_table(ps[:, None], 1, dim)
    assert [int(v) for v in mu.numpy().view(U)] == want
    assert modmath_cuda.barrett_table(ps[:, None], 1, dim) is mu
    assert [int(v) for v in modmath_cuda.barrett_table(ps[2:5, None], 1, 3).numpy().view(U)] \
        == want[2:5]
    assert [int(v) for v in modmath_cuda.barrett_table(ps[1:2], 0, 4).numpy().view(U)] \
        == [want[1]] * 4


@pytest.fixture
def model_lib(monkeypatch):
    """ops/modmath_cuda.py's wrappers with the model in place of the library:
    CPU tensors pass the device check, the model reads their memory."""
    lib = mm.ModelLib()
    monkeypatch.setattr(modmath_cuda, "_lib", lib)
    monkeypatch.setattr(cuda_build, "check_device", lambda *a: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda dev: 0)
    return lib


@pytest.fixture(scope="module")
def edge_cases():
    rings = {59: PolyContext(10, q=1 << 20, dim_cap=72),
             29: PolyContext(10, q=1 << 20, logp=29, dim_cap=72)}
    return modmath_edge_cases(torch.device("cpu"), rings)


def test_ew_launches_at_the_edges(model_lib, edge_cases):
    """torch_cases.py's K5 edge cases through the wrapper and the model of the
    launch: equal to the plain version, every output word written once, and
    every branch of the design taken (16-byte pairs, a per-row constant and
    word loads for each operand, pair and word stores, tails, the loop over
    A past 65535, blocks of fewer than EW_THREADS threads)."""
    seen = []
    for case in edge_cases:
        before = len(model_lib.plans)
        out = modmath_cuda.elementwise(*case["args"])
        eq, err, _ = ew_compare(out, case["plain"]())
        assert eq, (case["entry"], case["shape"], err)
        assert len(model_lib.plans) == before + 1
        seen += model_lib.plans[before:]
    for operand in ("x", "y"):
        for path in ("pair", "const", "word"):
            assert any(p["paths"][operand][path] for p in seen), (operand, path)
    assert any(p["store_pair"] for p in seen) and any(p["store_word"] for p in seen)
    # a row read in pairs and another word by word in one launch: the offset rows
    assert any(p["paths"]["x"]["pair"] and p["paths"]["x"]["word"] for p in seen)
    for key, want in (("tail", {True, False}), ("z_loop", {True, False}),
                      ("op", {0, 1, 2, 3}), ("threads", {32, 256})):
        assert want <= {p[key] for p in seen}, key


@pytest.mark.parametrize("op", ["mulmod", "mont_mul", "addmod", "submod"])
def test_ew_loops_past_the_grid(model_lib, op):
    """More slabs and primes than blocks on the grid's y and z axes (65535
    on the card; 2 here): a block walks rows of A after rows, making each
    row's bases and constants once, and every word is written once."""
    model_lib.grid_z = 2
    pctx = CHAINS[59]
    dim = 5
    rng = np.random.default_rng(len(op))
    ba = tr.make_basis_arrays(pctx, dim, "cpu")
    p = np.asarray(pctx.primes[:dim], dtype=U)[:, None]
    x = torch.from_numpy(_residues(rng, p, (5, dim, 1030)).view(np.int64))
    y = torch.from_numpy(_residues(rng, p, (dim, 1030)).view(np.int64))
    consts = {"mulmod": (ba.ps[:, None], ba.pinv[:, None], ba.r2[:, None]),
              "mont_mul": (ba.ps[:, None], ba.pinv[:, None])}.get(op, (ba.ps[:, None],))
    got = modmath_cuda.elementwise(op, x, y, *consts)
    assert torch.equal(got, getattr(tm, f"plain_{op}")(x, y, *consts))
    plan = model_lib.plans[-1]
    assert plan["z_loop"] and plan["grid"] == (2, dim, 2) and plan["tail"]


def test_ew_refuses_rows_past_32_bit_offsets():
    x = torch.zeros((1, 1), dtype=torch.int64).expand(1, modmath_cuda.EW_MAX_N)
    p = torch.ones((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="fewer than"):
        modmath_cuda.elementwise("addmod", x, x, p)


@pytest.mark.parametrize("entry", ["cross_terms", "key_products", "mulmod_sum"])
def test_fused_entries_through_the_model(model_lib, entry):
    """The fused entries' C interface as the wrappers call it (the model runs
    their arithmetic word by word): equal to the plain versions on a batch,
    the key bank's row slices and a sum against both key halves."""
    pctx = CHAINS[29]
    dim, n = 4, 64
    rng = np.random.default_rng(3)
    ba = tr.make_basis_arrays(pctx, dim + 2, "cpu")
    c = (ba.ps[:dim, None], ba.pinv[:dim, None], ba.r2[:dim, None])
    p = np.asarray(pctx.primes[:dim + 2], dtype=U)[:, None]

    def res(lead, rows=dim):
        return torch.from_numpy(_residues(rng, p[:rows], lead + (rows, n)).view(np.int64))
    if entry == "cross_terms":
        x = res((4, 2))
        got, want = modmath_cuda.cross_terms(x, *c), tm.plain_cross_terms(x, *c)
    elif entry == "key_products":
        x, bank = res((2,)), res((2,), dim + 2)
        got = modmath_cuda.key_products(x, bank[0][:dim], bank[1][:dim], *c)
        want = tm.plain_key_products(x, bank[0][:dim], bank[1][:dim], *c)
    else:
        x, y, w = res((3,)), res((3,)), [res((3,), dim + 2)[:, :dim] for _ in range(2)]
        got = modmath_cuda.sums("mulmod_sum", x, y, tuple(w), *c)
        want = tm.plain_mulmod_sum(x, y, *c, ws=w)
    assert torch.equal(got, want)
