"""The mesh's five sharded programs (parallel/mesh.py: the counterparts of
the JAX package's tpu_jit around shard_map, gpqhe_tpu/parallel/mesh.py)
as graphs, on the CPU through StandIn (tests/torch_standin.py), on the
59-bit chain; test_torch_mesh_graphs29.py runs the same tests on logp=29.

On the virtual (2,2,2) CPU mesh of torch_mesh_cases.MeshCase at
logn=6/logq=110/slots=4/Delta=2^30 (the (limb=4, batch=2) mesh for the 2-D
poly_mul), each program's first call (warm-up and capture) and two replays,
each on its own inputs, are np.array_equal to the JAX package's program on
the same numpy inputs and torch.equal to the port's program run eagerly
under graphs.disabled().  The mesh's traffic and the launch counters after
replays equal the eager calls'; the key halves, slabs and key stacks are
read in place; MeshCKKS's ops equal the single-device engine's.  The
layout rule (HeMesh.graphable) and a failing capture are tested once, here.
Tolerance: none, every path is integer.
"""

import contextlib

import numpy as np
import pytest
import torch

from gpqhe_tpu.algo.linalg import HoistedGemvPlan as JHoistedGemvPlan
from gpqhe_tpu.context import PolyContext as JPolyContext
from gpqhe_tpu.parallel import mesh as jmesh
from gpqhe_tpu.ring import sample as jsmp

from torch_mesh_cases import MeshCase, bat, cross, jbat
from torch_standin import StandIn
import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.algo import linalg as tlin
from gpqhe_tpu_torch.context import PolyContext
from gpqhe_tpu_torch.ops.modmath import u64_to_torch
from gpqhe_tpu_torch.parallel import mesh as tmesh
from gpqhe_tpu_torch.parallel.engine import MeshCKKS
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy, limbs_to_torch
from gpqhe_tpu_torch.substrate.surf import Surf
from gpqhe_tpu_torch.utils import graphs

torch.set_num_threads(1)

LOGP = 59
CPU8 = ["cpu"] * 8
CALLS = ("first", "replay1", "replay2")      # each on its own input set
PROGRAMS = ("poly_mul", "poly_mul_3d", "mul_rs", "mul_rs_one", "rot1", "conj", "gemv_step")
BOUND = {"mul_rs": (4, 5), "rot1": (2, 3), "conj": (2, 3), "gemv_step": (2, 3, 4, 5)}


def _words(out) -> list:
    """A program's output (a tensor or a tuple of them) as numpy words."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [limbs_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x) for x in outs]


def _tensors(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


class Runs:
    """Per program: the port's program, its mesh, and three input sets, each
    as the JAX program's arguments and the port's; the JAX outputs, the
    port's graphed (first call, then replays) and eager outputs."""

    def __init__(self, logp: int):
        self.case = c = MeshCase(logp)
        c.eng.ring.graphs = graphs.Graphs(StandIn())
        c.mesh.graphs = graphs.Graphs(StandIn())
        je, l = c.jeng, c.ctx.L
        jcts = [c.jct1, c.jct2, je.enc_pk(je.ecd(jsmp.sample_z01vec(je.rng, c.jctx.slots)),
                                          c.jpk)]
        self.cts = [cross(x, "ct") for x in jcts]
        self.jcts = jcts
        self.prog, self.mesh, self.jax, self.args = {}, {}, {}, {}
        self._poly_muls(logp)
        rlk = cross(c.jrlk, "swk")
        pairs = [(0, 1), (1, 0), (2, 0)]
        self._add("mul_rs", tmesh.build_sharded_mul_rs(c.eng, l, c.mesh), c.mesh,
                  jmesh.build_sharded_mul_rs(je, l, c.jmesh),
                  [(jbat(jcts[i].c0), jbat(jcts[i].c1), jbat(jcts[k].c0), jbat(jcts[k].c1),
                    c.jrlk.p0hat, c.jrlk.p1hat) for i, k in pairs],
                  [(bat(self.cts[i].c0), bat(self.cts[i].c1), bat(self.cts[k].c0),
                    bat(self.cts[k].c1), rlk.p0hat, rlk.p1hat) for i, k in pairs])
        # one ciphertext pair, as MeshCKKS hands it in: batch row 0 of the same program
        self.prog["mul_rs_one"], self.mesh["mul_rs_one"] = self.prog["mul_rs"], c.mesh
        self.jax["mul_rs_one"] = [tuple(x[0] for x in out) for out in self.jax["mul_rs"]]
        self.args["mul_rs_one"] = [(self.cts[i].c0, self.cts[i].c1, self.cts[k].c0,
                                    self.cts[k].c1, rlk.p0hat, rlk.p1hat) for i, k in pairs]
        for name, r, jswk in (("rot1", 1, c.jrk[1]), ("conj", None, c.jck)):
            swk = cross(jswk, "swk")
            self._add(name, tmesh.build_sharded_rot(c.eng, l, c.mesh, r), c.mesh,
                      jmesh.build_sharded_rot(je, l, c.jmesh, r),
                      [(jbat(x.c0), jbat(x.c1), jswk.p0hat, jswk.p1hat) for x in jcts],
                      [(bat(x.c0), bat(x.c1), swk.p0hat, swk.p1hat) for x in self.cts])
        self._gemv_step()
        self.got = {p: [self.prog[p](*a) for a in self.args[p]] for p in PROGRAMS}
        self.n_graphs = {p: len(self.prog[p].graphs) for p in PROGRAMS}
        with graphs.disabled():
            self.eager = {p: [self.prog[p](*a) for a in self.args[p]] for p in PROGRAMS}

    def _add(self, name, prog, mesh, jf, jargs, targs):
        self.prog[name], self.mesh[name], self.args[name] = prog, mesh, targs
        self.jax[name] = [jf(*a) for a in jargs]

    def _poly_muls(self, logp: int):
        """Both poly_mul programs on B=4 random 100-bit polynomial pairs over
        enough primes of the chain for the exact product."""
        dim, K, B, n = (4 if logp == 59 else 8), 4, 4, 64
        kw = dict(logn=6, q=1 << 100, dim_cap=dim, logp=logp)
        rng = np.random.default_rng(logp)
        sets = []
        for _ in CALLS:
            a, b = rng.integers(0, 1 << 32, (2, B, n, K), dtype=np.uint32)
            a[..., -1] &= 0xF
            b[..., -1] &= 0xF
            sets.append((a, b))
        for name, jmk, mk in (
                ("poly_mul", lambda: jmesh.make_he_mesh(8, limb=4),
                 lambda: tmesh.make_he_mesh(8, limb=4, devices=CPU8)),
                ("poly_mul_3d", lambda: jmesh.make_he_mesh3(8, limb=2, coeff=2),
                 lambda: tmesh.make_he_mesh3(8, limb=2, coeff=2, devices=CPU8))):
            build_j = getattr(jmesh, f"build_sharded_{name}")
            build_t = getattr(tmesh, f"build_sharded_{name}")
            mesh = mk()
            mesh.graphs = graphs.Graphs(StandIn())
            self._add(name, build_t(PolyContext(**kw), dim, K, 32 * K, K, mesh), mesh,
                      build_j(JPolyContext(**kw), dim, K, 32 * K, K, jmk()), sets,
                      [(limbs_to_torch(a), limbs_to_torch(b)) for a, b in sets])

    def _gemv_step(self):
        """One double-hoisted giant step on the prologue of each ciphertext
        (the JAX engine's, crossed as u64 words); one slab and one key stack,
        converted once, so that the graphs read them in place."""
        c = self.case
        je, l = c.jeng, c.ctx.L
        rng = np.random.default_rng(3)
        n = c.jctx.slots * c.jctx.slots
        plan = JHoistedGemvPlan(je, rng.standard_normal(n) + 1j * rng.standard_normal(n))
        dims_h, dimc, _ = plan.dims(je, l)
        dims_h += dims_h % 2
        dimc += dimc % 2
        prep = je.hoisted_gemv_prep_fn(l, plan.n1, dims_h, dimc)
        consts = (*plan.pack_slab(je, l, 0, dims=(dims_h, dimc)), *plan.rk_stack(c.jrk))
        tconsts = tuple(u64_to_torch(np.asarray(x)) for x in consts)
        jargs = [(*prep(x.c0, x.c1), *consts) for x in self.jcts]
        self._add("gemv_step", tmesh.build_sharded_gemv_step(c.eng, l, plan.n1, dims_h, dimc,
                                                             c.mesh), c.mesh,
                  jmesh.build_sharded_gemv_step(je, l, plan.n1, dims_h, dimc, c.jmesh), jargs,
                  [(*(u64_to_torch(np.asarray(y)) for y in a[:2]), *tconsts) for a in jargs])


@pytest.fixture(scope="module")
def runs(request):
    return Runs(request.module.LOGP)


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("program", PROGRAMS)
def test_graphed_program_bit_equal_to_jax_and_eager(runs, program, call):
    i = CALLS.index(call)
    got, eager = runs.got[program][i], runs.eager[program][i]
    want = _words(runs.jax[program][i])
    assert len(_words(got)) == len(want) == len(_words(eager))
    for g, w in zip(_words(got), want):
        assert g.shape == w.shape and np.array_equal(g, w)
    for g, e in zip(_tensors(got), _tensors(eager)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("program", PROGRAMS)
def test_one_graph_a_shape(runs, program):
    """Three calls of one shape: one capture, then replays (mul_rs holds a
    second graph for its unbatched shape); the first result outlived them."""
    assert isinstance(runs.prog[program], graphs.Program)
    assert runs.n_graphs[program] == (2 if program.startswith("mul_rs") else 1)
    first = runs.got[program][0]
    for g, e in zip(_tensors(first), _tensors(runs.eager[program][0])):
        assert torch.equal(g, e)


@pytest.mark.parametrize("program", [p for p in PROGRAMS if p != "mul_rs_one"])
def test_replays_count_the_traffic_and_launches_of_eager_calls(runs, program):
    """Two replays add to the counters (the mesh's traffic among them) what
    two eager calls add."""
    prog, mesh, args = runs.prog[program], runs.mesh[program], runs.args[program][:2]
    gains, traffic = [], []
    for eager in (False, True):
        mesh.reset_traffic()
        before = graphs.counters_snapshot()
        with graphs.disabled() if eager else contextlib.nullcontext():
            for a in args:
                prog(*a)
        gains.append(graphs.counters_delta(before))
        traffic.append(mesh.traffic)
    assert gains[0] == gains[1] and any(gains[0])
    assert traffic[0] == traffic[1] and traffic[0]["psum"][0] > 0 and traffic[0]["gather"][0] > 0


@pytest.mark.parametrize("program", list(BOUND))
def test_constants_are_read_in_place(runs, program):
    """The key halves (and the gemv's slabs and key stacks) are bound: no
    static copy; the same tensors replay, copies of them at other addresses
    capture anew and give the same result."""
    prog, args = runs.prog[program], runs.args[program][0]
    bound = BOUND[program]
    for g in prog.graphs.values():
        assert all((s is None) == (i in bound) for i, s in enumerate(g.static_in))
    owner = prog.owner
    captures, replays = owner.captures, owner.replays
    moved = tuple(a.clone() if i in bound else a for i, a in enumerate(args))
    out = prog(*moved)
    assert (owner.captures, owner.replays) == (captures + 1, replays)
    again = prog(*moved)
    assert (owner.captures, owner.replays) == (captures + 1, replays + 1)
    for x, y, z in zip(_tensors(out), _tensors(again), _tensors(runs.eager[program][0])):
        assert torch.equal(x, z) and torch.equal(y, z)


@pytest.fixture(scope="module")
def engines(runs):
    """MeshCKKS on the case's graphable CPU mesh (the stand-in's graphs) and
    the single-device engine, on the JAX package's keys."""
    c = runs.case
    meng = MeshCKKS(c.ctx, c.mesh, rng=Surf(), hoist_bits=160)
    meng.ring.graphs = graphs.Graphs(StandIn())
    rk = {r: cross(k, "swk") for r, k in c.jrk.items()}
    keys = dict(rlk=cross(c.jrlk, "swk"), ck=cross(c.jck, "swk"), rk=rk)
    rng = np.random.default_rng(5)
    A = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    plans = {e: tlin.HoistedGemvPlan(e, A) for e in (meng, c.eng)}
    return meng, c.eng, keys, plans


MESH_OPS = {
    "mul_rs": lambda e, k, p, x, y: e.mul_rs(x, y, k["rlk"]),
    "rot": lambda e, k, p, x, y: e.rot(x, 1, k["rk"]),
    "conj": lambda e, k, p, x, y: e.conj(x, k["ck"]),
    "gemv_full": lambda e, k, p, x, y: tlin.gemv_hoisted_full(e, p[e], x, k["rk"]),
}


@pytest.mark.parametrize("op", list(MESH_OPS))
def test_mesh_engine_ops_graphed_equal_single_device(runs, engines, op):
    """MeshCKKS hands each sharded program one ciphertext: on three inputs
    its graphed ops equal the single-device engine's eager ops; each of
    its sharded programs is a program with graphs."""
    meng, eng, keys, plans = engines
    cts = runs.cts
    for x, y in ((cts[0], cts[1]), (cts[1], cts[2]), (cts[2], cts[0])):
        got = MESH_OPS[op](meng, keys, plans, x, y)
        with graphs.disabled():
            want = MESH_OPS[op](eng, keys, plans, x, y)
        assert (got.l, got.nu, got.B) == (want.l, want.nu, want.B)
        assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
    head = {"mul_rs": "mul_rs", "rot": "rot", "conj": "rot", "gemv_full": "gemvstep"}[op]
    progs = [p for k, p in meng._mesh_jit.items() if k[0] == head]
    assert progs and all(isinstance(p, graphs.Program) and p.graphs for p in progs)


def test_graphable_is_one_process_on_one_device(runs):
    """The layout rule, fixed when a mesh is made: a virtual mesh is
    graphable; positions on two devices or a process group are not, and
    their programs are the eager functions, with the reason said."""
    virtual = tmesh.make_he_mesh3(8, limb=2, coeff=2, devices=CPU8)
    assert virtual.graphable and virtual.eager_why is None
    two = tmesh.make_he_mesh3(4, limb=2, coeff=2, devices=["cpu", "meta"] * 2)
    assert not two.graphable and "2 devices (cpu, meta)" in two.eager_why
    grouped = tmesh.HeMesh(virtual.devices, tmesh._AXES, group=object())
    assert not grouped.graphable and "processes" in grouped.eager_why
    pctx = PolyContext(logn=6, q=1 << 100, dim_cap=4)
    assert isinstance(tmesh.build_sharded_poly_mul_3d(pctx, 4, 4, 128, 4, virtual),
                      graphs.Program)
    assert not isinstance(tmesh.build_sharded_poly_mul_3d(pctx, 4, 4, 128, 4, grouped),
                          graphs.Program)
    c = runs.case
    assert not isinstance(tmesh.build_sharded_rot(c.eng, c.ctx.L, tmesh.HeMesh(
        c.mesh.devices, tmesh._AXES, group=object()), 1), graphs.Program)


def test_a_failing_capture_on_a_graphable_mesh_raises(runs):
    """No fallback to the eager walk: a capture that fails raises, in the
    mesh's own graphs (poly_mul) and in an engine's (mul_rs)."""
    mesh = tmesh.make_he_mesh3(8, limb=2, coeff=2, devices=CPU8)
    mesh.graphs = graphs.Graphs(StandIn(fail=True))
    kw = dict(logn=6, q=1 << 100, dim_cap=4, logp=runs.case.ctx.logp_prime)
    f = tmesh.build_sharded_poly_mul_3d(PolyContext(**kw), 4, 4, 128, 4, mesh)
    with pytest.raises(RuntimeError, match=r"capture of program \('sharded_poly_mul'"):
        f(*runs.args["poly_mul_3d"][0])
    c = runs.case
    eng = gt.CKKS(c.ctx, rng=Surf(), device="cpu", hoist_bits=160)
    eng.ring.graphs = graphs.Graphs(StandIn(fail=True))
    with pytest.raises(RuntimeError, match=r"capture of program \('sharded_mul_rs'"):
        tmesh.build_sharded_mul_rs(eng, c.ctx.L, c.mesh)(*runs.args["mul_rs"][0])
