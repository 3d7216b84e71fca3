"""The port's parallel/mesh.py against the JAX package's, below the engine:
the mesh object and its three collectives, the coefficient-sharded NTT, the
per-shard kernel tables, the limb-sharded reconstruct and the two poly_mul
programs.

The JAX side runs on the 8 virtual CPU devices that conftest.py asks XLA
for, under jax.jit; the port runs on a virtual mesh that names the CPU eight
times.  Inputs come from numpy or `random` seeds and go through both.
Tolerance: none, every comparison is np.array_equal / torch.equal.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.ops import rns as jrns
from gpqhe_tpu.parallel import mesh as jmesh
from gpqhe_tpu.substrate import bigint

from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops import ntt as twin
from gpqhe_tpu_torch.ops import ntt_cuda
from gpqhe_tpu_torch.ops import rns as trns
from gpqhe_tpu_torch.ops.modmath import torch_to_u64, u64_to_torch
from gpqhe_tpu_torch.parallel import mesh as tmesh
from gpqhe_tpu_torch.ring.poly import RingEngine
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy, limbs_to_torch

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
SHARDS = [1, 2, 4, 8]


# -- the mesh object -----------------------------------------------------------

def test_mesh_shapes():
    mesh = tmesh.make_he_mesh(8, devices=CPU8)
    assert mesh.shape == dict(jmesh.make_he_mesh(8).shape) == {"limb": 4, "batch": 2}
    assert tmesh.make_he_mesh(8, limb=2, devices=CPU8).shape == {"limb": 2, "batch": 4}
    mesh3 = tmesh.make_he_mesh3(8, limb=2, coeff=2, devices=CPU8)
    assert mesh3.shape == dict(jmesh.make_he_mesh3(8, limb=2, coeff=2).shape) \
        == {"limb": 2, "coeff": 2, "batch": 2}
    assert mesh3.devices.shape == (2, 2, 2) and len(mesh3.positions) == 8
    assert mesh3.first_device == torch.device("cpu")
    assert tmesh.make_he_mesh3(None, limb=2, coeff=4, devices=CPU8).shape["batch"] == 1
    with pytest.raises(ValueError, match="do not fill"):
        tmesh.make_he_mesh3(8, limb=3, coeff=2, devices=CPU8)


def test_mesh_without_devices_wants_that_many_gpus():
    """devices=None means distinct CUDA devices: one more than the machine
    has raises, whatever it has; it never falls back to the CPU and never
    repeats a device."""
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"needs {have + 1} devices.*has {have} CUDA"):
        tmesh.make_he_mesh3(have + 1, limb=1, coeff=have + 1)
    with pytest.raises(RuntimeError, match="needs 8 devices; devices= lists 2"):
        tmesh.make_he_mesh(8, limb=4, devices=["cpu", "cpu"])


def test_collectives_and_their_traffic():
    mesh = tmesh.make_he_mesh3(8, limb=2, coeff=2, devices=CPU8)
    x = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    parts = tmesh._scatter(mesh, x, ("batch", "coeff", None))
    assert set(parts) == set(mesh.positions)
    for (j, s, b), blk in parts.items():
        assert torch.equal(blk, x[2 * b:2 * b + 2, 3 * s:3 * s + 3])
    assert torch.equal(tmesh._gather(mesh, parts, ("batch", "coeff", None)), x)
    assert mesh.traffic["scatter"] == [8, 8 * 18 * 8] and mesh.traffic["gather"] == [4, 4 * 18 * 8]
    y = torch.arange(4 * 6).reshape(4, 6)
    key = tmesh._scatter(mesh, y, ("limb", "coeff"))
    assert torch.equal(key[1, 0, 1], y[2:, :3]) and torch.equal(key[0, 1, 0], y[:2, 3:])
    assert torch.equal(tmesh._gather(mesh, key, ("limb", "coeff")), y)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh._scatter(mesh, x, (None, None, "coeff"))

    mesh.reset_traffic()
    vals = {pos: torch.tensor([1 + pos[0], 10 * pos[1], 100 * pos[2]]) for pos in mesh.positions}
    tot = tmesh._psum_limb(mesh, vals)
    for (j, s, b), t in tot.items():
        assert t.tolist() == [3, 20 * s, 200 * b]
    assert mesh.traffic["psum"] == [8, 8 * 24]           # in and out of 4 columns
    swapped = tmesh._ppermute_coeff_xor(mesh, vals, 1)
    for (j, s, b), t in swapped.items():
        assert t.tolist() == [1 + j, 10 * (s ^ 1), 100 * b]
    assert mesh.traffic["ppermute"] == [8, 8 * 24]

    placed = tmesh.shard_ciphertext_batch(mesh, x)
    assert all(torch.equal(blk, x[2 * b:2 * b + 2]) for (j, s, b), blk in placed.items())


# -- the coefficient-sharded NTT -----------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_coeff_ntt_plan_equals_the_original(S):
    kw = dict(logn=8, q=1 << 100, dim_cap=3)
    a = jmesh.make_coeff_ntt_plan(JPolyContext(**kw), 3, S)
    b = tmesh.make_coeff_ntt_plan(PolyContext(**kw), 3, S)
    for k in ("zl_f", "zl_i", "zc_f", "zc_i"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for k in ("S", "L", "logS", "f_lengths", "i_lengths"):
        assert a[k] == b[k], k


@functools.lru_cache(maxsize=None)
def _jax_coeff_ntt(S):
    """JAX's shard_map run of the bare coefficient-sharded NTT and its
    inverse over S virtual devices (tests/test_parallel.py:121-168)."""
    logn, dim = 8, 2
    pctx = JPolyContext(logn, q=1 << 100, dim_cap=dim)
    ba = jrns.make_basis_arrays(pctx, dim)
    cp = jmesh.make_coeff_ntt_plan(pctx, dim, S)
    splan = {k: cp[k] for k in ("S", "L", "logS", "f_lengths", "i_lengths")}
    mesh = Mesh(np.array(jax.devices()[:S]), axis_names=("coeff",))
    ps, pinv, ninv = jnp.asarray(ba.ps), jnp.asarray(ba.pinv), jnp.asarray(ba.ninv_mont)
    specs = dict(in_specs=(P(None, "coeff"), P(None, "coeff", None), P(None, None, "coeff")),
                 out_specs=P(None, "coeff"))
    fwd = jax.jit(shard_map(
        lambda x, zl, zc: jmesh._ntt_coeff_sharded(x, zl, zc, ps, pinv, splan, "coeff"),
        mesh=mesh, check_vma=False, **specs))
    inv = jax.jit(shard_map(
        lambda x, zl, zc: jmesh._intt_coeff_sharded(x, zl, zc, ps, pinv, ninv, splan, "coeff"),
        mesh=mesh, check_vma=False, **specs))
    return (lambda a: np.asarray(fwd(jnp.asarray(a), jnp.asarray(cp["zl_f"]),
                                     jnp.asarray(cp["zc_f"]))),
            lambda a: np.asarray(inv(jnp.asarray(a), jnp.asarray(cp["zl_i"]),
                                     jnp.asarray(cp["zc_i"]))))


@pytest.mark.parametrize("S", SHARDS)
def test_coeff_sharded_ntt_matches_jax_and_the_twin(S):
    """S = 8 is three cross stages over 32-coefficient shards.  Forward
    equals JAX's shard_map run and the port's single-device twin; the
    inverse equals JAX's and gives the input back."""
    logn, dim = 8, 2
    pctx = PolyContext(logn, q=1 << 100, dim_cap=dim)
    rng = np.random.default_rng(3)
    a = np.stack([rng.integers(0, p, 1 << logn, dtype=np.uint64) for p in pctx.primes[:dim]])
    a[:, :2] = np.array(pctx.primes[:dim], dtype=np.uint64)[:, None] - np.uint64(1)
    jfwd, jinv = _jax_coeff_ntt(S)

    mesh = tmesh.make_he_mesh3(S, limb=1, coeff=S, devices=["cpu"] * S)
    splan, C = tmesh._basis_consts(mesh, pctx, dim, 2, "a")
    assert splan["L"] == (1 << logn) // S and len(splan["f_lengths"]) == S.bit_length() - 1
    x = tmesh._scatter(mesh, u64_to_torch(a), (None, "coeff"))
    got = tmesh._ntt_coeff_sharded(mesh, x, C, "a", splan)
    hat = torch_to_u64(tmesh._gather(mesh, got, (None, "coeff")))
    ba = trns.make_basis_arrays(pctx, dim, "cpu")
    assert np.array_equal(hat, torch_to_u64(twin.ntt(u64_to_torch(a), ba.zetas, ba.ps, ba.pinv)))
    assert np.array_equal(hat, jfwd(a))
    back = torch_to_u64(tmesh._gather(
        mesh, tmesh._intt_coeff_sharded(mesh, got, C, "a", splan), (None, "coeff")))
    assert np.array_equal(back, jinv(hat)) and np.array_equal(back, a)
    swaps = (S.bit_length() - 1) * S
    assert mesh.traffic["ppermute"] == [2 * swaps, 2 * swaps * dim * ((1 << logn) // S) * 8]


@pytest.mark.parametrize("word,logp", [(64, 59), (32, 29)])
def test_shard_kernel_tables_equal_std_and_shoup_of_the_jax_tables(word, logp):
    """The kernel's per-shard tables are made from the Montgomery tables of
    the coefficient plan, row by row: equal to std_and_shoup of JAX's zl_f /
    zl_i, interleaved [dim, L, 2] and contiguous; a plan of rows r0..r1-1 is
    a contiguous view of them with the ring's n^-1 and no p-hat scale."""
    kw = dict(logn=8, q=1 << 100, logp=logp, dim_cap=4)
    S, dim = 4, 4
    jp = jmesh.make_coeff_ntt_plan(JPolyContext(**kw), dim, S)
    pctx = PolyContext(**kw)
    dtype = torch.int64 if word == 64 else torch.int32
    for s in range(S):
        t = ntt_cuda.kernel_tables(pctx.primes, jp["zl_f"][:, s], jp["zl_i"][:, s], "cpu", word)
        for got, table in ((t.tw_f, jp["zl_f"][:, s]), (t.tw_i, jp["zl_i"][:, s])):
            assert got.shape == (dim, 64, 2) and got.dtype == dtype and got.is_contiguous()
            for d, p in enumerate(pctx.primes):
                z, zs = ntt_cuda.std_and_shoup(table[d], p, word)
                bits = got[d].numpy().view(np.uint64 if word == 64 else np.uint32)
                assert np.array_equal(bits[:, 0], z) and np.array_equal(bits[:, 1], zs)
        st = ntt_cuda.ShardTables(pctx, jp["zl_f"][:, s], jp["zl_i"][:, s], "cpu", word)
        plan = st.plan(2, 4)
        assert (plan.dim, plan.n, plan.tables, plan.scale_phat) == (2, 64, None, None)
        assert np.array_equal(torch_to_u64(plan.ba.zetas), jp["zl_f"][2:4, s])
        assert np.array_equal(torch_to_u64(plan.ba.ninv_mont),
                              np.array([pc.ninv_mont for pc in pctx.prime_ctx[2:4]], np.uint64))
        with pytest.raises(ValueError, match="no scaled inverse"):
            ntt_cuda.intt(torch.zeros((2, 64), dtype=torch.int64), plan, scaled=True)
    # the inverse's multiplier is the ring's n^-1 (n = 256), not L^-1
    sc = ntt_cuda.scale_words(pctx.primes, pctx.n, word, "cpu")
    bits = sc.numpy().view(np.uint64 if word == 64 else np.uint32)
    for d, p in enumerate(pctx.primes):
        assert int(bits[0, d]) * 256 % p == 1 and int(bits[1, d]) == (int(bits[0, d]) << word) // p


# -- the limb-sharded reconstruct ------------------------------------------------

def test_sharded_reconstruct_large_basis_psum_exact():
    """Limb-sum CRT reconstruct at dim=80 over 8 shards with adversarial
    max-digit residues (tests/test_parallel.py:257-319): equal to the port's
    single-device reconstruct, to JAX's, and to a Python-integer CRT oracle."""
    logn, dim, nloc, nshard = 6, 80, 8, 8
    pctx = PolyContext(logn, q=1 << 100, dim_cap=dim)
    b = pctx.basis(dim)
    y_np = np.full((dim, nloc), (1 << 56) - 1, dtype=np.uint64)
    rng = np.random.default_rng(5)
    y_np[:, -2:] = np.stack([rng.integers(0, p, 2, dtype=np.uint64) for p in b.primes], axis=0)

    ba = trns.make_basis_arrays(pctx, dim, "cpu")
    plan = trns.make_recon_plan(pctx, dim, "cpu")
    y = u64_to_torch(y_np)
    single = trns.reconstruct(y, ba, plan, center=True, pre_scaled=True)

    # reconstruct_sharded multiplies its residues by the phatinv constant
    # itself: hand it y with the Montgomery form of 1, so that the digits
    # it sums are those of y, as on the pre-scaled single-device path
    rows = dim // nshard
    one = u64_to_torch(np.array([pc.r2 * pow(1 << 64, -1, pc.p) % pc.p      # R mod p: mont 1
                                 for pc in pctx.prime_ctx[:dim]], dtype=np.uint64))
    res, consts = {}, {}
    for k in range(nshard):
        r = slice(k * rows, (k + 1) * rows)
        res[k] = y[r]
        consts[k] = (ba.ps[r], ba.pinv[r], one[r],
                     trns.make_recon_plan(pctx, dim, "cpu", rows=(r.start, r.stop)))
        assert consts[k][3].phat_digits.shape == (plan.nd * rows, plan.ds)

    def psum(parts):
        total = functools.reduce(torch.add, [parts[k] for k in sorted(parts)])
        return {k: total for k in parts}
    sharded = trns.reconstruct_sharded(res, consts, psum, center=True)
    for k in range(nshard):
        assert torch.equal(sharded[k], single), k

    jpctx = JPolyContext(logn, q=1 << 100, dim_cap=dim)
    jplan = jrns.make_recon_plan(jpctx, dim)
    jba = jrns.make_basis_arrays(jpctx, dim)
    jsingle = np.asarray(jax.jit(lambda v: jrns.reconstruct(
        v, jba, jplan, center=True, pre_scaled=True))(jnp.asarray(y_np)))
    assert np.array_equal(limbs_to_numpy(single), jsingle)
    for i in range(nloc):
        S = sum(int(y_np[d, i]) * b.phat[d] for d in range(dim))
        v = S % b.P
        if v > b.P // 2:
            v -= b.P
        assert np.array_equal(limbs_to_numpy(single[i]), bigint.int_to_limbs(v, plan.ks)), i


def test_sub_basis_plan_rows_are_zero_outside_the_basis():
    """r = c mod P over the first 2 primes of a 6-prime stack on 3 limb
    shards: shard 0 holds the basis, shards 1 and 2 all-zero rows, and the
    rows are digit-major over the local primes."""
    pctx = PolyContext(6, q=1 << 100, dim_cap=6)
    full = trns.make_recon_plan(pctx, 2, "cpu")
    shards = [trns.make_recon_plan(pctx, 2, "cpu", rows=(2 * j, 2 * j + 2)) for j in range(3)]
    assert torch.equal(shards[0].phat_digits, full.phat_digits)
    assert torch.equal(shards[0].inv_p, full.inv_p)
    for sh in shards[1:]:
        assert sh.phat_digits.shape == full.phat_digits.shape
        assert not sh.phat_digits.any() and not sh.inv_p.any()
        assert torch.equal(sh.P_limbs, full.P_limbs) and sh.dim == 2
    odd = trns.make_recon_plan(pctx, 3, "cpu", rows=(2, 4))       # one prime in, one out
    whole = trns.make_recon_plan(pctx, 3, "cpu").phat_digits.reshape(odd.nd, 3, odd.ds)
    local = odd.phat_digits.reshape(odd.nd, 2, odd.ds)
    assert torch.equal(local[:, 0], whole[:, 2]) and not local[:, 1].any()


# -- the poly_mul programs -------------------------------------------------------

@pytest.mark.parametrize("shape", ["limb4_batch2", "limb2_coeff2_batch2"])
def test_sharded_poly_mul_matches_jax_and_single(shape):
    """tests/test_parallel.py:20-69: the (limb, batch) and the (limb, coeff,
    batch) product of B=4 random 100-bit polynomial pairs at logn=6 over 4
    primes, against JAX's program on the same mesh shape and against the
    port's single-device poly_mul."""
    random.seed(7 if shape == "limb4_batch2" else 11)
    logn, dim, K, B = 6, 4, 4, 4
    n = 1 << logn
    kw = dict(logn=logn, q=1 << 100, dim_cap=dim)
    a = np.stack([bigint.ints_to_limbs([random.getrandbits(100) for _ in range(n)], K)
                  for _ in range(B)])
    b = np.stack([bigint.ints_to_limbs([random.getrandbits(100) for _ in range(n)], K)
                  for _ in range(B)])
    if shape == "limb4_batch2":
        jf = jmesh.build_sharded_poly_mul(JPolyContext(**kw), dim, K, 32 * K, K,
                                          jmesh.make_he_mesh(8, limb=4))
        mesh = tmesh.make_he_mesh(8, limb=4, devices=CPU8)
        tf = tmesh.build_sharded_poly_mul(PolyContext(**kw), dim, K, 32 * K, K, mesh)
    else:
        jf = jmesh.build_sharded_poly_mul_3d(JPolyContext(**kw), dim, K, 32 * K, K,
                                             jmesh.make_he_mesh3(8, limb=2, coeff=2))
        mesh = tmesh.make_he_mesh3(8, limb=2, coeff=2, devices=CPU8)
        tf = tmesh.build_sharded_poly_mul_3d(PolyContext(**kw), dim, K, 32 * K, K, mesh)
    want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = limbs_to_torch(a), limbs_to_torch(b)
    got = tf(ta, tb)
    assert got.shape == (B, n, K) and np.array_equal(limbs_to_numpy(got), want)
    ring = RingEngine(PolyContext(**kw), device="cpu")
    for i in range(B):
        assert torch.equal(got[i], ring.poly_mul(ta[i], tb[i], dim, 32 * K, K)), i
    assert mesh.traffic["psum"][0] > 0
    assert (mesh.traffic["ppermute"][0] > 0) == (shape != "limb4_batch2")
    with pytest.raises(AssertionError):
        tmesh.build_sharded_poly_mul(PolyContext(**kw), 3, K, 32 * K, K, mesh)
