"""The port's copied host modules equal the JAX package's originals.

gpqhe_tpu_torch carries its own copies of the jax-free host modules, because
`import gpqhe_tpu.<anything>` runs gpqhe_tpu/__init__.py, which imports jax,
and the GPU machine has no jax.  These tests hold each copy equal to its
original: the files themselves, the surf stream, the context tables, the
samplers and the canonical embedding.  A subprocess with jax blocked shows
the port imports and builds an engine without it.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpqhe_tpu.context as jctx
from gpqhe_tpu.ring import canemb as jcan
from gpqhe_tpu.ring import sample as jsmp
from gpqhe_tpu.substrate import surf as jsurf

import gpqhe_tpu_torch.context as tctx
from gpqhe_tpu_torch.ring import canemb as tcan
from gpqhe_tpu_torch.ring import sample as tsmp
from gpqhe_tpu_torch.substrate import surf as tsurf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gpqhe_tpu_torch")

COPIED = ["params.py", "context.py", "substrate/__init__.py", "substrate/bigint.py",
          "substrate/surf.py", "substrate/fips202.py", "substrate/native/__init__.py",
          "substrate/native/substrate.c", "ring/sample.py", "ring/canemb.py",
          "algo/nonlinear.py", "utils/__init__.py", "utils/info.py",
          "substrate/rng_backends.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_file_is_verbatim(rel):
    with open(os.path.join(ROOT, "gpqhe_tpu", rel), "rb") as f:
        want = f.read()
    with open(os.path.join(PORT, rel), "rb") as f:
        assert f.read() == want, f"{rel} drifted from gpqhe_tpu/{rel}"


@pytest.mark.parametrize("seed", [None, np.arange(32, dtype=np.uint32) * 7 + 1])
def test_surf_stream_bytes(seed):
    a, b = jsurf.Surf(seed), tsurf.Surf(seed)
    for nbytes in (1, 7, 4096, 40000, 3):
        assert np.array_equal(a.randombytes(nbytes), b.randombytes(nbytes))


def _ctx_pair(logn, logq, slots, logD):
    return (jctx.HeContext(logn, 1 << logq, slots, 1 << logD),
            tctx.HeContext(logn, 1 << logq, slots, 1 << logD))


@pytest.mark.parametrize("logn,logq,slots,logD", [(11, 48, 4, 22), (14, 438, 16, 50)])
def test_context_tables(logn, logq, slots, logD):
    a, b = _ctx_pair(logn, logq, slots, logD)
    for attr in ("L", "q", "dim", "P", "PqL", "dimevk", "dimswk", "slots", "Delta"):
        assert getattr(a, attr) == getattr(b, attr), attr
    for fn in ("dim_dec", "dim_mul", "dim_swk", "bits_mul", "bits_swk"):
        for l in range(a.L + 1):
            assert getattr(a, fn)(l) == getattr(b, fn)(l), (fn, l)
    for fn in ("dim_genswk", "dim_rlk_s2"):
        assert getattr(a, fn)() == getattr(b, fn)()
    assert vars(a.bounds) == vars(b.bounds)
    pa, pb = a.poly, b.poly
    assert pa.primes == pb.primes and pa.dimub == pb.dimub
    assert np.array_equal(pa.cyc_group, pb.cyc_group)
    assert np.array_equal(pa.ring_zetas, pb.ring_zetas)
    for i in (0, pa.dimub - 1):
        for f in ("p", "pinv_mont", "ninv_mont", "r2"):
            assert getattr(pa.prime_ctx[i], f) == getattr(pb.prime_ctx[i], f)
        assert np.array_equal(pa.prime_ctx[i].zetas, pb.prime_ctx[i].zetas)
        assert np.array_equal(pa.prime_ctx[i].zetas_inv, pb.prime_ctx[i].zetas_inv)
    for dim in sorted({a.dim, a.dim_mul(a.L), a.dim_swk(a.L)}):
        ba, bb = pa.basis(dim), pb.basis(dim)
        for f in ("P", "P_half", "phat", "phat_invmp"):
            assert getattr(ba, f) == getattr(bb, f)
        for f in ("ps", "pinv_mont", "ninv_mont", "r2", "phatinv_mont", "ninvphat_mont"):
            assert np.array_equal(getattr(ba, f), getattr(bb, f))


def test_main_path_dims():
    """The sizes the main path runs at (logn=14, logq=438, slots=16, 2^50)."""
    b = tctx.HeContext(14, 1 << 438, 16, 1 << 50)
    assert (b.L, b.dim, b.dim_mul(b.L), b.dim_swk(b.L), b.dimswk, b.poly.dimub) \
        == (8, 8, 16, 24, 24, 30)


@pytest.mark.parametrize("sampler", ["sk", "error", "zo", "z01", "uniform"])
def test_samplers(sampler):
    n = 2048
    q = (1 << 48) * 12345
    out = []
    for smp, surf in ((jsmp, jsurf), (tsmp, tsurf)):
        rng = surf.Surf()
        if sampler == "sk":
            v = smp.sample_sk(rng, n)
        elif sampler == "error":
            v = smp.sample_error(rng, n)
        elif sampler == "zo":
            v = smp.sample_zo(rng, n)
        elif sampler == "z01":
            v = smp.sample_z01vec(rng, 16)
        else:
            v = smp.uniform_bytes_to_limbs(smp.sample_uniform_bytes(rng, n, q),
                                           q.bit_length(), 3)
        out.append((v, rng.randombytes(16)))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1]), "stream position diverged"


def test_canemb_roundtrip_equal():
    a, b = _ctx_pair(11, 48, 4, 22)
    rng = np.random.default_rng(5)
    m = rng.random(4) + 1j * rng.random(4)
    ua = jcan.invcanemb(m, 4, a.poly.cyc_group, a.poly.ring_zetas, a.poly.m)
    ub = tcan.invcanemb(m, 4, b.poly.cyc_group, b.poly.ring_zetas, b.poly.m)
    assert np.array_equal(ua, ub)
    assert np.array_equal(jcan.canemb(ua, 4, a.poly.cyc_group, a.poly.ring_zetas, a.poly.m),
                          tcan.canemb(ub, 4, b.poly.cyc_group, b.poly.ring_zetas, b.poly.m))


@pytest.mark.parametrize("S", [1, 4])
def test_coeff_ntt_plan_equals_the_original(S):
    """parallel/mesh.py::make_coeff_ntt_plan is host numpy carried over
    unchanged: its four tables at the main-path ring's width."""
    from gpqhe_tpu.parallel.mesh import make_coeff_ntt_plan as jplan
    from gpqhe_tpu_torch.parallel.mesh import make_coeff_ntt_plan as tplan
    a = jplan(jctx.PolyContext(10, 1 << 27, dim_cap=3), 3, S)
    b = tplan(tctx.PolyContext(10, 1 << 27, dim_cap=3), 3, S)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k], k


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_import_in_port():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gpqhe_tpu"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gpqhe_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from gpqhe_tpu_torch import CKKS, HeContext, Surf\n"
        "import gpqhe_tpu_torch.ops.ntt_cuda, gpqhe_tpu_torch.ops.ntt_cuda32\n"
        "import gpqhe_tpu_torch.scheme.types, gpqhe_tpu_torch.algo.linalg\n"
        "import gpqhe_tpu_torch.algo.nonlinear, gpqhe_tpu_torch.bootstrap\n"
        "import gpqhe_tpu_torch.utils.serialize, gpqhe_tpu_torch.utils.trace\n"
        "import gpqhe_tpu_torch.utils.pmu, gpqhe_tpu_torch.utils.info\n"
        "import gpqhe_tpu_torch.cli, gpqhe_tpu_torch.__main__\n"
        "import gpqhe_tpu_torch.substrate.rng_backends\n"
        "import gpqhe_tpu_torch.parallel, gpqhe_tpu_torch.parallel.mesh\n"
        "import gpqhe_tpu_torch.parallel.dist, gpqhe_tpu_torch.parallel.mp_mul_rs\n"
        "from gpqhe_tpu_torch.parallel.engine import MeshCKKS\n"
        "from gpqhe_tpu_torch.parallel.mesh import make_he_mesh3\n"
        "eng = CKKS(HeContext(11, 1 << 48, 4, 1 << 22), rng=Surf(), device='cpu')\n"
        "pk, sk = eng.keypair()\n"
        "mesh = make_he_mesh3(4, limb=2, coeff=2, devices=['cpu'] * 4)\n"
        "meng = MeshCKKS(eng.ctx, mesh, rng=Surf())\n"
        "ct = meng.enc_pk(meng.ecd([0.5, 0.25, 0.125, 1.0]), pk)\n"
        "assert meng.conj(ct, meng.genck(sk)).l == ct.l and meng._mesh_jit\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'gpqhe_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', eng.device)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok cpu"
