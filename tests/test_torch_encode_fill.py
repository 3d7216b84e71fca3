"""Constant and encoded plaintexts from their nonzero rows, against the JAX
package's limbs.

CKKS.const_pt has two nonzero coefficients (0 and n/2) and a sparse ecd
2 slots of them (j * gap); the port computes only those rows' limbs on the
host and has ops/limbs.py::fill_rows write the dense [n, kq] tensor on the
engine's device (on a card one launch of csrc/limbs.cu's fill kernel, the
limbs in its parameters: no copy).  A full-packing ecd (n = 2 slots) is
dense and is still built on the host and copied.  Each plaintext must be
np.array_equal to the JAX package's (gpqhe_tpu/scheme/engine.py const_pt,
ecd) with the same nu, mod_bits and bound, and trace.ENCODE counts which
route it took.  tests/test_torch_cuda.py holds the kernel against
plain_fill_rows on the card.
"""

import re

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu import bootstrap as jbs

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.ops import cuda_build, limbs, limbs_cuda
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
from gpqhe_tpu_torch.utils import trace

torch.set_num_threads(1)

RINGS = {
    # the bootstrap's smoke ring (tests/test_torch_bootstrap_e2e.py): 20 limbs, gap 4
    "boot": dict(logn=4, q=1 << 610, slots=2, Delta=1 << 30),
    "sparse": dict(logn=9, q=1 << 120, slots=4, Delta=1 << 30),
    "full": dict(logn=4, q=1 << 100, slots=8, Delta=1 << 30),
}
CONSTS = [0, 1, -1, 0.5, 9, -1.0 / 48, 1j, 0.375 - 2.25j]
_engines = {}


def _engines_of(ring):
    """(JAX engine, port engine on the CPU) of a ring, made once."""
    if ring not in _engines:
        _engines[ring] = (gpqhe_tpu.CKKS(gpqhe_tpu.HeContext(**RINGS[ring])),
                          gt.CKKS(gt.HeContext(**RINGS[ring]), device="cpu"))
    return _engines[ring]


def _message(kind, ctx):
    """(message, nu) of an ecd case."""
    slots = ctx.slots
    if kind == "random":
        rng = np.random.default_rng(5)
        return rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots), None
    q_src = float(ctx.q[1])
    if kind == "exp_small_a":       # bootstrap._exp_small_a's constant, at Delta^2
        a = 2 * np.pi * ctx.Delta / q_src * 1j / (1 << jbs.min_bootstrap_iter(ctx))
        return np.full(slots, a, dtype=np.complex128), float(ctx.Delta) ** 2
    if kind == "evalsin_b":         # mod_reduce's q_src / (4 pi i Delta), at Delta
        return np.full(slots, q_src / (4j * np.pi * ctx.Delta), dtype=np.complex128), None
    assert kind == "huge"           # coefficients past 2^62: the exact-int branch
    return np.full(slots, 2.0 ** 40 - 3j * 2.0 ** 38, dtype=np.complex128), None


def _same_plaintext(j, t):
    assert np.array_equal(np.asarray(j.m), limbs_to_numpy(t.m))
    assert (j.nu, j.mod_bits, j.bound) == (t.nu, t.mod_bits, t.bound)


def _counted(fn):
    """fn()'s result and the change it made to trace.ENCODE and trace.H2D's copies."""
    enc, copies = dict(trace.ENCODE), trace.H2D["copies"]
    out = fn()
    return out, ({k: v - enc[k] for k, v in trace.ENCODE.items()},
                 trace.H2D["copies"] - copies)


@pytest.mark.parametrize("ring", ["boot", "sparse", "full"])
@pytest.mark.parametrize("num", CONSTS, ids=[str(c) for c in CONSTS])
def test_const_pt_is_the_jax_packages_and_filled_on_the_device(ring, num):
    jeng, teng = _engines_of(ring)
    t, (enc, copies) = _counted(lambda: teng.const_pt(num))
    _same_plaintext(jeng.const_pt(num), t)
    assert enc == {"on_card": 1, "host": 0} and copies == 0


@pytest.mark.parametrize("ring,kind", [("boot", "exp_small_a"), ("boot", "evalsin_b"),
                                       ("boot", "random"), ("boot", "huge"),
                                       ("sparse", "random"), ("sparse", "evalsin_b"),
                                       ("full", "random"), ("full", "huge")])
def test_ecd_is_the_jax_packages_filled_when_sparse(ring, kind):
    """Sparse packing takes the fill (no copy); full packing keeps the
    host's dense build and its one copy."""
    jeng, teng = _engines_of(ring)
    m, nu = _message(kind, teng.ctx)
    t, (enc, copies) = _counted(lambda: teng.ecd(m, nu=nu))
    _same_plaintext(jeng.ecd(m, nu=nu), t)
    if kind == "huge":
        assert t.bound >= 2.0 ** 62
    if ring == "full":
        assert enc == {"on_card": 0, "host": 1} and copies == 1
    else:
        assert enc == {"on_card": 1, "host": 0} and copies == 0
    assert np.allclose(teng.dcd(t), m, rtol=1e-6, atol=1e-6) or kind == "exp_small_a"


@pytest.mark.parametrize("n,k,stride", [(16, 3, 8), (16, 4, 4), (64, 5, 1), (1 << 10, 14, 64)])
def test_plain_fill_rows_places_the_rows(n, k, stride):
    rows = np.random.default_rng(n + k).integers(0, 1 << 32, size=(n // stride, k),
                                                 dtype=np.uint64).astype(np.uint32)
    want = np.zeros((n, k), dtype=np.uint32)
    want[::stride] = rows
    before = dict(limbs_cuda.LAUNCHES)
    got = limbs.fill_rows(rows, n, stride, "cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert np.array_equal(limbs_to_numpy(got), want)
    assert torch.equal(got, limbs.plain_fill_rows(rows, n, stride))
    assert dict(limbs_cuda.LAUNCHES) == before          # the plain version launches nothing


def test_fill_words_mirror_the_source_and_bound_the_paths():
    """FILL_WORDS is limbs.cu's LIMBS_FILL_WORDS (2 KB of a launch's 4 KB of
    parameters) and holds the benchmark rings' sparse plaintexts: const_pt
    at 28 limbs, ecd at logn=15/slots=4 (224 words) and logn=14/slots=16 (448)."""
    src = open(limbs_cuda.SOURCE).read()
    assert int(re.search(r"^#define LIMBS_FILL_WORDS (\d+)", src, flags=re.M)[1]) == \
        limbs_cuda.FILL_WORDS
    assert 4 * limbs_cuda.FILL_WORDS <= 2048
    assert max(2 * 28, 2 * 4 * 28, 2 * 16 * 14) <= limbs_cuda.FILL_WORDS


def test_fill_rows_checks_its_arguments_before_loading(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel library was built or loaded")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(limbs_cuda, "_lib", None)
    ok = np.zeros((2, 4), dtype=np.uint32)
    with pytest.raises(ValueError, match="do not make"):
        limbs_cuda.fill_rows(ok, 16, 4, "cuda")                  # 2 rows 4 apart are 8
    with pytest.raises(ValueError, match="at most"):
        limbs_cuda.fill_rows(np.zeros((2, limbs_cuda.FILL_WORDS), np.uint32), 16, 8, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        limbs_cuda.fill_rows(ok, 16, 8, "cpu")
