"""K4 decompose and K6's digit split (csrc/rns.cu) without a card: the
numpy model of each kernel (tests/torch_rns_model.py) against Python
integers and the plain torch versions.

  - decompose's arithmetic (the limb constants made from the weights, the
    32 x 64-bit products summed in four 32-bit words by the PTX carry
    chain, one Montgomery reduction a group of 256 limbs, the signed form) on edge rows: all 0xFFFFFFFF, 0, the
    multiples of p and their neighbours, two's-complement values at every
    src_bits edge, on the 59-bit, logp=29 and logp=9 primes;
  - both launches' work split (blocks, tiles of primes, lanes and warps,
    staged chunks, the slab loop, the 16-byte pairs): every output word
    written once, through ops/rns_cuda.py's wrappers as they call the
    library, on chip_smoke.py's edge cases (the card runs the same ones);
  - the model's constants against rns.cu's #defines.
The file compiles no JAX program.
"""

import re

import numpy as np
import pytest
import torch

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import cuda_build, rns_cuda
from gpqhe_tpu_torch.ops import rns as tr
from gpqhe_tpu_torch.substrate import bigint

import torch_rns_model as rm
import torch_rowwarp_model as rt
from chip_smoke import CRT_CHAIN, ew_compare, rns_edge_cases

torch.set_num_threads(1)

U = np.uint64
CHAINS = {59: PolyContext(6, q=1 << 20, dim_cap=24),
          29: PolyContext(6, q=1 << 20, logp=29, dim_cap=24),
          9: PolyContext(4, **CRT_CHAIN)}


def _edge_rows(K, primes, src_bits):
    """Python ints of K limbs: all ones, 0, k p - 1, k p, k p + 1 for the
    first prime and multiples up to the top of the row, and (src_bits) the
    two's-complement edges -1, -2^(src-1), 2^(src-1) - 1, 1 with any bits
    above src_bits set or clear."""
    top = 1 << (32 * K)
    vals = [top - 1, 0, 1]
    for p in primes[:2]:
        for k in (1, 2, 3, (top - 1) // p, (top - 1) // p - 1, 1 << 17):
            vals += [v for v in (k * p - 1, k * p, k * p + 1) if 0 <= v < top]
    if src_bits:
        s = src_bits
        low = [(1 << s) - 1, 1 << (s - 1), (1 << (s - 1)) - 1, 1, (1 << s) - 2]
        vals += low + [v | (top - (1 << s)) for v in low]
    return vals


@pytest.mark.parametrize("logp", [59, 29, 9])
@pytest.mark.parametrize("K", [1, 2, 3, 14, 28, 65, 300])
def test_decompose_arithmetic_on_edge_rows(logp, K):
    """The model of the kernel's sums and reduction equals v mod p, and the
    signed form (v mod 2^src) - 2^src mod p for a row whose bit src - 1 is
    set, at src_bits 1, 31, 32, 33, 32 K - 5 and 32 K."""
    pctx = CHAINS[logp]
    dim = min(6, len(pctx.primes))
    p = np.asarray(pctx.primes[:dim], dtype=U)
    pinv = np.asarray(pctx.basis(dim).pinv_mont, dtype=U)
    w = tr.make_decomp_weights(pctx, dim, K)
    for src in sorted(b for b in {0, 1, 31, 32, 33, 32 * K - 5, 32 * K} if b <= 32 * K):
        vals = _edge_rows(K, pctx.primes, src)
        x = np.stack([bigint.int_to_limbs(v, K) for v in vals]).astype(U)
        got, nh = rm.decompose_rows(x, w, p, pinv, src)
        assert nh == {59: 2, 29: 1, 9: 1}[logp]
        if src:
            vals = [(v % (1 << src)) - (1 << src) if (v >> (src - 1)) & 1 else v for v in vals]
        want = np.array([[v % q for v in vals] for q in pctx.primes[:dim]], dtype=object)
        assert np.array_equal(got.astype(object), want), (src, logp, K)


def test_decompose_sums_stay_in_their_words():
    """The bounds the kernel's reduction rests on, at their extremes: a
    group of 256 limbs of 0xFFFFFFFF against constants of p - 1 sums below
    2^128 (one half: below 2^96), and its high 64-bit word stays below p,
    for the smallest and the largest primes of the three chains."""
    for p in (CHAINS[9].primes[0], CHAINS[29].primes[-1], CHAINS[59].primes[0],
              CHAINS[59].primes[-1]):
        top = rm.DEC_GROUP * (2**32 - 1) * (p - 1)
        assert top < 2**(64 * rm.halves_of(p) + 32) and top >> 64 < p


def _defines(path):
    return {m[0]: int(m[1]) for m in
            re.findall(r"^#define (\w+) (\d+)", open(path).read(), flags=re.M)}


def test_rns_constants_mirror_the_source():
    d = _defines(rns_cuda.SOURCE)
    for name in ("DEC_WARPS", "DEC_ROWS", "DEC_PRIMES", "DEC_KC", "DEC_GROUP", "SPLIT_WARPS",
                 "SPLIT_COEFS"):
        assert d[name] == getattr(rm, name), name
    # a warp takes two primes of a tile and a lane two rows, 32 apart
    assert rm.DEC_PRIMES == 2 * rm.DEC_WARPS and rm.DEC_ROWS == 64
    assert rm.SPLIT_COEFS == 2 * 32 and rm.DEC_GROUP % rm.DEC_KC == 0


def test_fastdiv_splits_the_staged_chunks():
    """The staging loops split a flat index by the chunk's limbs (1-64) with
    rowwarp.cuh's FastDiv: exact over a block's rows (and the tile's primes)."""
    idx = np.arange(rm.DEC_ROWS * rm.DEC_KC, dtype=U)
    for kc in range(1, rm.DEC_KC + 1):
        d = rt.fastdiv(kc)
        sub = idx[:rm.DEC_ROWS * kc]
        assert np.array_equal(d(sub), sub // U(kc)), kc


@pytest.fixture
def model_lib(monkeypatch):
    """ops/rns_cuda.py's wrappers with the model in place of the library:
    CPU tensors pass the device check, the model reads their memory."""
    lib = rm.ModelLib()
    monkeypatch.setattr(rns_cuda, "_lib", lib)
    monkeypatch.setattr(cuda_build, "check_device", lambda *a: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda dev: 0)
    return lib


def _run(lib, case):
    before = len(lib.plans)
    out = getattr(rns_cuda, case["op"])(*case["args"])
    return out, lib.plans[before:]


@pytest.fixture(scope="module")
def edge_cases():
    rings = {59: PolyContext(10, q=1 << 20, dim_cap=72),
             29: PolyContext(10, q=1 << 20, logp=29, dim_cap=72)}
    return rns_edge_cases(torch.device("cpu"), rings)


def test_decompose_launches_at_the_edges(model_lib, edge_cases):
    """chip_smoke.py's decompose edge cases through the wrapper and the
    model of the launch: equal to the plain version, every output word
    written once, and every branch of the design taken (one and two 32-bit
    halves a constant, one and several tiles of primes, one and two staged chunks of
    limbs, a second group of 256 limbs, a partial block, signed rows; S = 0
    launches nothing)."""
    seen = []
    for case in (c for c in edge_cases if c["entry"] == "decompose"):
        out, plans = _run(model_lib, case)
        assert torch.equal(out, case["plain"]()), case["shape"]
        assert len(plans) == (1 if out.numel() else 0), case["shape"]
        seen += plans
    assert set().union(*(p["nh"] for p in seen)) == {1, 2}
    for key, want in (("tiles", {1, 2, 3}), ("chunks", {1, 2, 5}), ("groups", {1, 2}),
                      ("partial_block", {True}), ("signed", {True, False})):
        assert want <= {p[key] for p in seen}, key


def test_digit_split_launches_at_the_edges(model_lib, edge_cases):
    """chip_smoke.py's digit-split edge cases through the wrapper and the
    model: the digits equal the plain version's, af within a relative
    2^-45 (ew_compare), every digit and estimate written once, and the
    16-byte pairs, the word stores, the 16-byte loads and the word loads all
    taken, at 1, 2 and 4 digits, scaled or not."""
    seen = []
    for case in (c for c in edge_cases if c["entry"] == "crt_digit_split"):
        out, plans = _run(model_lib, case)
        eq, err, extra = ew_compare(out, case["plain"]())
        assert eq, (case["shape"], err, extra)
        seen += plans
    for key, want in (("pair", {True, False}), ("vload", {True, False}), ("nd", {1, 2, 4}),
                      ("scaled", {True, False}), ("partial_block", {True, False})):
        assert want <= {p[key] for p in seen}, key
    assert max(p["primes_a_warp"] for p in seen) >= 6


@pytest.mark.parametrize("K", [3, 70])
def test_slab_loop_past_the_grid(model_lib, K):
    """More slabs than blocks on the grid's last axis (65535 on the card; 2
    here): a block walks slab after slab, decompose making its constants
    once where a row fits one chunk, and every word is written once."""
    model_lib.grid_z = 2
    pctx = CHAINS[59]
    rng = np.random.default_rng(4)
    ba = tr.make_basis_arrays(pctx, 5, "cpu")
    a = torch.from_numpy(rng.integers(0, 1 << 32, size=(5, 70, K), dtype=np.int64))
    w = torch.from_numpy(tr.make_decomp_weights(pctx, 5, K).view(np.int64))
    for src in (None, 32 * K - 3):
        got = rns_cuda.decompose(a, ba.ps, ba.pinv, w, src)
        assert torch.equal(got, tr.decompose_core(a, ba.ps, ba.pinv, w, src))
        assert model_lib.plans[-1]["slab_loop"]
    plan = tr.make_recon_plan(pctx, 5, "cpu")
    y = torch.from_numpy((rng.integers(0, 1 << 62, size=(5, 5, 70), dtype=np.uint64)
                          % np.asarray(pctx.primes[:5], dtype=U)[:, None]).view(np.int64))
    assert ew_compare(rns_cuda.digit_split(y, plan.nd, plan.inv_p),
                      tr.plain_digit_split(y, plan.nd, plan.inv_p))[0]
    assert model_lib.plans[-1]["slab_loop"]
