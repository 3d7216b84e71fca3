"""The port's utils (serialize, trace, pmu, info) and substrate/rng_backends
against the JAX package's.

One small ring, logn=5/logq=100/slots=2/Delta=2^30 (L=3); both engines draw
from the same Surf() stream, so their keys and ciphertexts are bit-equal and
a file written by one package must hold exactly what the other would write:
  serialize — all six kinds (ct, pt, pk, sk, swk, rotation-key bank) cross
      both ways with equal member names, dtypes and arrays; a header that
      does not match the context raises in both; load() without a device
      means the GPU and raises where there is none.
  trace — one op_trace over the same warm op sequence counts the same op
      names the same number of times in both packages (utils/trace.py's
      docstring says what cannot be counted alike: an op's first call).
  pmu — Timer and time_jitted on the CPU.
  info — the show_* printers print the same lines.
  rng_backends — the AES-256 CTR DRBG stream.
"""

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.algo import linalg as jlin
from gpqhe_tpu.substrate import rng_backends as jrng
from gpqhe_tpu.substrate import surf as jsurf
from gpqhe_tpu.utils import info as jinfo
from gpqhe_tpu.utils import serialize as jser
from gpqhe_tpu.utils import trace as jtrace

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.algo import linalg as tlin
from gpqhe_tpu_torch.scheme.types import to_numpy
from gpqhe_tpu_torch.substrate import rng_backends as trng
from gpqhe_tpu_torch.substrate import surf as tsurf
from gpqhe_tpu_torch.utils import info as tinfo
from gpqhe_tpu_torch.utils import pmu as tpmu
from gpqhe_tpu_torch.utils import serialize as tser
from gpqhe_tpu_torch.utils import trace as ttrace

torch.set_num_threads(1)

PARAMS = dict(logn=5, q=1 << 100, slots=2, Delta=1 << 30)
KINDS = ["ct", "pt", "pk", "sk", "swk", "rk"]


def _setup(pkg, surf, **kw):
    ctx = pkg.HeContext(**PARAMS)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    m = np.array([0.25 + 0.5j, -0.75 + 0.125j])
    pt = eng.ecd(m)
    ct = eng.enc_pk(pt, pk)
    return dict(ctx=ctx, eng=eng, pk=pk, sk=sk, swk=rlk, ck=ck, rk=rk, pt=pt, ct=ct, m=m)


@pytest.fixture(scope="module")
def both():
    return _setup(gpqhe_tpu, jsurf), _setup(gt, tsurf, device="cpu")


def _same_port(a, b):
    """Two objects of the port hold equal arrays and ledgers."""
    (ka, xa), (kb, xb) = to_numpy(a), to_numpy(b)
    assert ka == kb and xa.keys() == xb.keys()
    for f in xa:
        assert xa[f].dtype == xb[f].dtype and np.array_equal(xa[f], xb[f]), f


def _same_files(path_a, path_b):
    """Two .npz files hold the same members with equal dtypes and values."""
    with np.load(path_a) as za, np.load(path_b) as zb:
        assert sorted(za.files) == sorted(zb.files) and "header" in za.files
        for name in za.files:
            assert za[name].dtype == zb[name].dtype, name
            assert np.array_equal(za[name], zb[name]), name


@pytest.mark.parametrize("kind", KINDS)
def test_jax_saved_file_loads_in_the_port(both, kind, tmp_path):
    j, t = both
    path = str(tmp_path / f"{kind}.npz")
    jser.save(path, j["ctx"], j[kind])
    got = tser.load(path, t["ctx"], device="cpu")
    assert type(got) is type(t[kind])
    _same_port(got, t[kind])            # the port's own object, from the same stream
    again = str(tmp_path / f"{kind}_port.npz")
    tser.save(again, t["ctx"], got)
    _same_files(path, again)            # and it writes back what JAX wrote


@pytest.mark.parametrize("kind", KINDS)
def test_port_saved_file_loads_in_jax(both, kind, tmp_path):
    j, t = both
    path = str(tmp_path / f"{kind}.npz")
    tser.save(path, t["ctx"], t[kind])
    _same_port(tser.load(path, t["ctx"], device="cpu"), t[kind])   # round trip
    got = jser.load(path, j["ctx"])
    assert type(got) is type(j[kind])
    again = str(tmp_path / f"{kind}_jax.npz")
    jser.save(again, j["ctx"], got)
    _same_files(path, again)
    own = str(tmp_path / f"{kind}_own.npz")
    jser.save(own, j["ctx"], j[kind])   # what JAX writes for its own object
    _same_files(path, own)


def test_loaded_keys_compute_the_same(both, tmp_path):
    j, t = both
    path = str(tmp_path / "rlk.npz")
    jser.save(path, j["ctx"], j["swk"])
    rlk = tser.load(path, t["ctx"], device="cpu")
    a = t["eng"].mul_rs(t["ct"], t["ct"], rlk)
    b = t["eng"].mul_rs(t["ct"], t["ct"], t["swk"])
    assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)


def test_header_mismatch_raises(both, tmp_path):
    j, t = both
    path = str(tmp_path / "ct.npz")
    tser.save(path, t["ctx"], t["ct"])
    for pkg, ser, kw in ((gpqhe_tpu, jser, {}), (gt, tser, {"device": "cpu"})):
        other = pkg.HeContext(logn=5, q=1 << 100, slots=4, Delta=1 << 30)
        with pytest.raises(ValueError, match="context mismatch"):
            ser.load(path, other, **kw)
    assert tser._header(t["ctx"]) == jser._header(j["ctx"])
    with pytest.raises(TypeError):
        tser.save(path, t["ctx"], object())


def test_load_defaults_to_the_gpu(both, tmp_path):
    _, t = both
    path = str(tmp_path / "sk.npz")
    tser.save(path, t["ctx"], t["sk"])
    if torch.cuda.is_available():
        assert tser.load(path, t["ctx"]).s.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tser.load(path, t["ctx"])


def _op_sequence(r, lin):
    eng, ct, pt = r["eng"], r["ct"], r["pt"]
    low = eng.mul_rs(ct, ct, r["swk"])
    eng.rs(eng.mul(ct, ct, r["swk"]))
    eng.moddown(ct)
    eng.neg(eng.sub(eng.add(ct, ct), ct))
    eng.subpt(eng.addpt(ct, pt), pt)
    eng.rs(eng.mulpt(ct, pt))
    eng.rot(ct, 1, r["rk"])
    eng.conj(low, r["ck"])
    eng.dec(eng.enc_sk(pt, r["sk"]), r["sk"])
    eng.dec(eng.enc_pk(pt, r["pk"]), r["sk"])
    eng.genck(r["sk"])
    eng.mul_rs_batch([ct, ct], [ct, ct], r["swk"])
    lin.gemv(eng, None, ct, r["rk"], plan=r["plan"], hoisted=True)


def test_op_trace_counts_the_same_names(both):
    counts = []
    for r, lin, trace in ((both[0], jlin, jtrace), (both[1], tlin, ttrace)):
        r["plan"] = lin.HoistedGemvPlan(r["eng"], np.arange(4) / 8 + 0.5j)
        _op_sequence(r, lin)                 # first calls build the programs
        with trace.op_trace() as t:
            _op_sequence(r, lin)
        counts.append(dict(t.counts))
        assert set(t.seconds) == set(t.counts) and all(v >= 0 for v in t.seconds.values())
        assert t.report().splitlines()[0].split() == ["op", "calls", "total", "ms", "ms/call"]
    assert counts[0] == counts[1]
    assert {"he_mul_rs", "he_mul", "he_mulpt", "he_mul_rs_batch", "rs", "moddown", "add2",
            "sub2", "negm", "gal", "swk", "mul", "fwd", "add3", "negadd3", "hoistprep",
            "hoiststep"} <= set(counts[1])
    assert counts[1]["he_mul_rs"] == 1 and counts[1]["rs"] >= 4


def test_trace_leaves_no_wrapper_behind(both):
    eng = both[1]["eng"]
    ct, rlk = both[1]["ct"], both[1]["swk"]
    eng.mul_rs(ct, ct, rlk)
    before = dict(eng._fns)
    with ttrace.op_trace() as t:
        assert ttrace.maybe_wrap(("x",), len) is not len
        eng.mul_rs(ct, ct, rlk)
    assert t.counts == {"he_mul_rs": 1}
    assert all(eng._fns[k] is before[k] for k in before)      # the cache holds bare programs
    assert ttrace.maybe_wrap(("x",), len) is len               # identity when inactive


def test_timer_and_time_jitted_on_the_cpu(both, tmp_path):
    eng, ct = both[1]["eng"], both[1]["ct"]
    timer = tpmu.Timer()
    for _ in range(2):
        out = eng.add(ct, ct)
        with timer.measure("add", block_on=(out.c0, out.c1)):
            out = eng.add(ct, ct)
    cnt, tot = timer.records["add"]
    assert cnt == 2 and tot > 0
    lines = []
    timer.report(out=lines.append)
    assert len(lines) == 1 and lines[0].startswith("add") and "2 calls" in lines[0]
    sec = tpmu.time_jitted(lambda a, b: eng.add(a, b).c0, (ct, ct), iters=3, warmup=1)
    assert 0 < sec < 1
    with tpmu.device_trace(str(tmp_path / "prof")):
        eng.add(ct, ct)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_show_printers_print_the_same_lines(both):
    j, t = both
    out = [[], []]
    for lines, info, r in ((out[0], jinfo, j), (out[1], tinfo, t)):
        info.show_ctx_params(r["ctx"], out=lines.append)
        info.show_pt_params(r["ctx"], r["pt"], "pt", out=lines.append)
        info.show_ct_params(r["ctx"], r["ct"], "ct", out=lines.append)
    assert out[0] == out[1] and len(out[0]) > 10
    assert out[1][-2].startswith("[pt] pt: nu=") and "limbs=4" in out[1][-2]


def test_ctr_drbg_stream_matches():
    assert trng.aes256_ecb_encrypt_block(
        bytes(range(32)), bytes.fromhex("00112233445566778899aabbccddeeff")).hex() == \
        "8ea2b7ca516745bfeafc49904b496089"           # FIPS-197 C.3
    a = jrng.Aes256CtrDrbg(bytes(range(48)))
    b = trng.Aes256CtrDrbg(bytes(range(48)))
    for nbytes in (40, 16, 1, 100):
        assert bytes(a.randombytes(nbytes)) == bytes(b.randombytes(nbytes))
    r = trng.UrandomRng().randombytes(64)
    assert r.shape == (64,) and r.dtype == np.uint8
