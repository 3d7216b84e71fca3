"""utils/graphs.py, the port's counterpart of tpu_jit, on the CPU.

The wrapper's logic (keying by shape, static buffers, clones of the
outputs, the launch counters' replay, disabled(), errors) runs here through
StandIn, a stand-in for the capture primitive (graphs.CudaGraphs): a capture
runs the program into its outputs and keeps it, a replay runs it again into
the same outputs and leaves the launch counters as they were, as a graph's
replay runs no Python.  A test hands it to an engine with
`eng.ring.graphs = graphs.Graphs(StandIn())`; nothing in the package
chooses it.

At logn=9/logq=120/slots=4/Delta=2^30 on the 59-bit chain (three levels, and
room for the hoisting basis) both packages draw from one Surf() stream:
the keys, then mul_rs, rot, conj, mulpt, rs, mul_rs_batch and the hoisted
gemv (its prep and step programs; full and BSGS) through the stand-in, at
their first call and at a replay, are bit-equal to the JAX package's (its
programs jitted as they are) and torch.equal to the port run eagerly under
graphs.disabled().  On a card tests/test_torch_cuda.py holds the real graphs
to disabled().
"""

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.algo import linalg as jlin
from gpqhe_tpu.ring import sample as jsmp
from gpqhe_tpu.substrate import surf as jsurf

from gpubench.devtrace import kernel_module      # the repository root is on sys.path
from torch_cases import GRAPH_ENGINES, GRAPH_OPS, HOISTED, graph_case, graph_check
from torch_standin import StandIn
import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.algo import linalg as tlin
from gpqhe_tpu_torch.ops import cuda_build
from gpqhe_tpu_torch.parallel.engine import MeshCKKS
from gpqhe_tpu_torch.parallel.mesh import make_he_mesh3
from gpqhe_tpu_torch.ring import sample as tsmp
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
from gpqhe_tpu_torch.substrate import surf as tsurf
from gpqhe_tpu_torch.utils import graphs

torch.set_num_threads(1)

RING = dict(logn=9, q=1 << 120, slots=4, Delta=1 << 30)


def _objects(pkg, lin, smp, surf, **kw):
    """Keys, two ciphertexts, a plaintext and the gemv's plan and banks."""
    ctx = pkg.HeContext(**RING)
    eng = pkg.CKKS(ctx, rng=surf.Surf(), **kw)
    if kw:
        eng.ring.graphs = graphs.Graphs(StandIn())
    pk, sk = eng.keypair()
    o = dict(eng=eng, lin=lin, pk=pk, sk=sk, rlk=eng.genrlk(sk), ck=eng.genck(sk),
             rk=eng.genrk(sk))
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    m2 = smp.sample_z01vec(eng.rng, ctx.slots)
    o["ct1"], o["ct2"] = eng.enc_pk(eng.ecd(m1), pk), eng.enc_pk(eng.ecd(m2), pk)
    o["pt2"] = eng.ecd(m2)
    rng = np.random.default_rng(31)
    A = rng.random(ctx.slots ** 2) + 1j * rng.random(ctx.slots ** 2)
    o["plan"] = plan = lin.HoistedGemvPlan(eng, A)
    o["bank"] = {r: o["rk"][r] for r in o["rk"] if r < plan.n1 or r % plan.n1 == 0}
    return o


OPS = {
    "mul_rs": lambda o: o["eng"].mul_rs(o["ct1"], o["ct2"], o["rlk"]),
    "rot": lambda o: o["eng"].rot(o["ct1"], 1, o["rk"]),
    "conj": lambda o: o["eng"].conj(o["ct1"], o["ck"]),
    "mulpt": lambda o: o["eng"].mulpt(o["ct1"], o["pt2"]),
    "rs": lambda o: o["eng"].rs(o["ct2"]),
    "mul_rs_batch": lambda o: o["eng"].mul_rs_batch([o["ct1"], o["ct2"]],
                                                    [o["ct2"], o["ct1"]], o["rlk"]),
    "gemv_full": lambda o: o["lin"].gemv_hoisted_full(o["eng"], o["plan"], o["ct1"], o["rk"]),
    "gemv_bsgs": lambda o: o["lin"].gemv_hoisted(o["eng"], o["plan"], o["ct1"], o["bank"]),
}
KEYS = {"pk.p0": ("pk", "p0"), "pk.p1": ("pk", "p1"), "rlk.p0hat": ("rlk", "p0hat"),
        "ck.p1hat": ("ck", "p1hat"), "ct1.c0": ("ct1", "c0"), "ct2.c1": ("ct2", "c1")}


@pytest.fixture(scope="module")
def runs():
    """(the JAX package's outputs, the port's at the first call, at a replay,
    eagerly under disabled(), and the port's objects)."""
    j = _objects(gpqhe_tpu, jlin, jsmp, jsurf)
    want = {op: f(j) for op, f in OPS.items()}
    t = _objects(gt, tlin, tsmp, tsurf, device="cpu")
    first = {op: f(t) for op, f in OPS.items()}
    replay = {op: f(t) for op, f in OPS.items()}
    with graphs.disabled():
        eager = {op: f(t) for op, f in OPS.items()}
    return j, want, first, replay, eager, t


def _cts(x):
    return x if isinstance(x, list) else [x]


@pytest.mark.parametrize("name", list(KEYS))
def test_keys_made_through_graphed_programs_bit_equal(runs, name):
    j, *_, t = runs
    obj, field = KEYS[name]
    a, b = np.asarray(getattr(j[obj], field)), getattr(t[obj], field)
    b = (b.numpy().view(np.uint64) if a.dtype == np.uint64 else limbs_to_numpy(b))
    assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("call", ["first", "replay"])
@pytest.mark.parametrize("op", list(OPS))
def test_graphed_op_bit_equal_to_jax_and_eager(runs, op, call):
    _, want, first, replay, eager, _ = runs
    got = (first if call == "first" else replay)[op]
    for w, g, e in zip(_cts(want[op]), _cts(got), _cts(eager[op]), strict=True):
        assert (g.l, g.nu, g.B) == (w.l, w.nu, w.B) == (e.l, e.nu, e.B)
        for f in ("c0", "c1"):
            assert np.array_equal(np.asarray(getattr(w, f)), limbs_to_numpy(getattr(g, f)))
            assert torch.equal(getattr(g, f), getattr(e, f))


def test_the_path_captured_and_replayed(runs):
    """Every program of the path was captured once per shape and replayed;
    a program inside another one's first call (he_mul inside he_mul_rs) ran
    inline, with no graph of its own."""
    *_, t = runs
    eng = t["eng"]
    g = eng.ring.graphs
    L = eng.ctx.L
    graphed = {k for k, p in {**eng._fns, **eng.ring._progs}.items() if p.graphs}
    for key in [("he_mul_rs", L), ("he_mul_rs_batch", L, 2), ("swk", L)]:
        assert key in graphed, key
    heads = {k[0] for k in graphed}
    assert {"he_mulpt", "rs", "hoistprep", "hoiststep", "add2", "negadd", "add3",
            "fwd", "mul", "gal"} <= heads, heads
    assert ("he_mul", L) in eng._fns and not eng._fns[("he_mul", L)].graphs
    assert g.captures == sum(len(p.graphs) for p in {**eng._fns, **eng.ring._progs}.values())
    assert g.replays > g.captures > 0


def test_a_replay_leaves_earlier_results_alone(runs):
    """Two calls with different inputs: the first result is unchanged after
    the second, the two share no memory, and both equal the eager run."""
    *_, t = runs
    eng = t["eng"]
    ct3 = eng.add(t["ct1"], t["ct2"])
    a = eng.mul_rs(t["ct1"], t["ct2"], t["rlk"])
    keep = a.c0.clone(), a.c1.clone()
    b = eng.mul_rs(ct3, t["ct1"], t["rlk"])
    assert torch.equal(a.c0, keep[0]) and torch.equal(a.c1, keep[1])
    assert not torch.equal(a.c0, b.c0)
    ptrs = {x.untyped_storage().data_ptr() for x in (a.c0, a.c1, b.c0, b.c1)}
    assert len(ptrs) == 4
    with graphs.disabled():
        ea = eng.mul_rs(t["ct1"], t["ct2"], t["rlk"])
        eb = eng.mul_rs(ct3, t["ct1"], t["rlk"])
    for x, y in ((a, ea), (b, eb)):
        assert torch.equal(x.c0, y.c0) and torch.equal(x.c1, y.c1)


def test_a_new_shape_captures_the_same_shape_replays():
    g = graphs.Graphs(StandIn())
    prog = g.program(lambda x: x * 3 + 1, ("toy",))
    assert torch.equal(prog(torch.zeros(4, dtype=torch.int64)), torch.ones(4, dtype=torch.int64))
    assert (g.captures, g.replays) == (1, 0)
    assert torch.equal(prog(torch.ones(4, dtype=torch.int64)), torch.full((4,), 4))
    assert (g.captures, g.replays) == (1, 1)
    prog(torch.ones(5, dtype=torch.int64))
    prog(torch.ones(4, dtype=torch.int32))
    assert (g.captures, g.replays) == (3, 1) and len(prog.graphs) == 3
    # a strided argument of a captured shape replays (static buffers are dense)
    y = torch.arange(8, dtype=torch.int64)[::2]
    assert torch.equal(prog(y), y * 3 + 1) and (g.captures, g.replays) == (3, 2)


def test_outputs_are_clones_never_the_graphs_buffers():
    """An output that is an argument (or a view of one) comes back as a
    clone: no caller holds a static buffer a later replay writes."""
    g = graphs.Graphs(StandIn())
    prog = g.program(lambda x, y: (x, y[0], y[1]), ("views",))
    x, y = torch.arange(3), torch.arange(6).reshape(2, 3)
    prog(x, y)
    a = prog(x, y)
    b = prog(x + 10, y + 10)
    assert torch.equal(a[0], x) and torch.equal(a[1], y[0]) and torch.equal(b[2], y[1] + 10)
    static = {s.untyped_storage().data_ptr() for s in prog.graphs[next(iter(prog.graphs))]
              .static_in}
    for out in a + b:
        assert out.untyped_storage().data_ptr() not in static


def test_bound_arguments_are_read_in_place():
    """A bound argument is no copy: the graph reads the memory it was
    captured on, so a replay sees the tensor's current words; another
    tensor of the same shape has a graph of its own."""
    g = graphs.Graphs(StandIn())
    prog = g.program(lambda x, k: x + k, ("bound",), bound=(1,))
    x, k = torch.arange(4), torch.full((4,), 10)
    prog(x, k)
    assert torch.equal(prog(x, k), x + 10) and (g.captures, g.replays) == (1, 1)
    k.fill_(20)
    assert torch.equal(prog(x, k), x + 20) and (g.captures, g.replays) == (1, 2)
    assert torch.equal(prog(x, torch.full((4,), 30)), x + 30) and g.captures == 2
    assert all(gr.static_in[1] is None and gr.static_in[0] is not None
               for gr in prog.graphs.values())


def test_a_program_with_bound_arguments_keeps_its_latest_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 3)
    g = graphs.Graphs(StandIn())
    prog = g.program(lambda x, k: x * k, ("bounded",), bound=(1,))
    x = torch.arange(3)
    keys = [torch.full((3,), i) for i in range(5)]
    for k in keys:
        prog(x, k)
    assert (len(prog.graphs), g.captures) == (3, 5)
    prog(x, keys[4])
    assert (g.captures, g.replays) == (5, 1)
    assert torch.equal(prog(x, keys[0]), x * 0) and g.captures == 6


@pytest.fixture
def toy_counter():
    d = cuda_build.counters({"toy": 0})
    try:
        yield d
    finally:
        cuda_build.COUNTERS.remove(d)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_counters_after_replays_equal_the_eager_launches(toy_counter, n):
    """A graph adds again, at each replay, the launches its capture counted:
    after a first call and n replays the counters hold (n + 1) times one
    eager run's."""
    def fn(x):
        toy_counter["toy"] += 2                # two launches, as a wrapper counts them
        return x + 1
    g = graphs.Graphs(StandIn())
    prog = g.program(fn, ("counted",))
    x = torch.arange(4)
    prog(x)
    assert toy_counter["toy"] == 2 and g.captures == 1
    for _ in range(n):
        prog(x)
    assert toy_counter["toy"] == 2 * (n + 1) and g.replays == n
    with graphs.disabled():
        prog(x)
    assert toy_counter["toy"] == 2 * (n + 2)


def test_disabled_runs_the_program_itself():
    calls = []

    def fn(x):
        calls.append(x)
        return x
    g = graphs.Graphs(StandIn())
    prog = g.program(fn, ("eager",))
    x = torch.arange(3)
    with graphs.disabled():
        with graphs.disabled():
            assert prog(x) is x
        assert prog(x) is x
    assert g.captures == 0 and len(calls) == 2
    prog(x)
    assert g.captures == 1


def test_cpu_tensors_run_the_program_itself():
    """With the CUDA primitive (every engine's default) a CPU argument runs
    the program as it is: no capture, no copy, no clone."""
    g = graphs.Graphs()
    prog = g.program(lambda x: x, ("identity",))
    x = torch.arange(3)
    assert prog(x) is x and g.captures == 0 and not prog.graphs
    assert isinstance(gt.CKKS(gt.HeContext(**RING), device="cpu").ring.graphs.capture,
                      graphs.CudaGraphs)


def test_a_failing_capture_raises_and_counts_nothing(toy_counter):
    def fn(x):
        toy_counter["toy"] += 1
        return x + 1
    g = graphs.Graphs(StandIn(fail=True))
    prog = g.program(fn, ("fails",))
    with pytest.raises(RuntimeError, match=r"capture of program \('fails',\) failed"):
        prog(torch.arange(3))
    # the warm-up's launch counted, the capture's taken back; nothing cached
    assert toy_counter["toy"] == 1 and g.captures == 0 and not prog.graphs
    with pytest.raises(RuntimeError, match="capture of program"):
        prog(torch.arange(3))


def test_a_failing_replay_raises():
    g = graphs.Graphs(StandIn(fail_replay=True))
    prog = g.program(lambda x: x + 1, ("replay",))
    prog(torch.arange(3))
    with pytest.raises(RuntimeError, match="failed to launch"):
        prog(torch.arange(3))


def test_an_engine_whose_capture_fails_raises(runs):
    """No fallback to the eager program on the main path."""
    *_, t = runs
    eng = gt.CKKS(t["eng"].ctx, rng=tsurf.Surf(), device="cpu")
    eng.ring.graphs = graphs.Graphs(StandIn(fail=True))
    with pytest.raises(RuntimeError, match=r"capture of program \('he_mul_rs'"):
        eng.mul_rs(t["ct1"], t["ct2"], t["rlk"])


def test_mixed_devices_are_refused():
    g = graphs.Graphs(StandIn())
    prog = g.program(lambda x, y: x + y, ("mixed",))
    with pytest.raises(ValueError, match="arguments on meta"):
        prog(torch.zeros(2), torch.zeros(2, device="meta"))


def test_mesh_engine_graphs_its_single_device_programs(runs):
    """MeshCKKS graphs the programs it runs on its first device (rs, mulpt)
    and, on a mesh whose positions share one device, its sharded programs:
    the sharded rot is one graph, with the galois maps in front of it
    inline in its capture (a gal program, no graph of its own).  Each
    result equals the single-device engine's."""
    *_, t = runs
    eng = t["eng"]
    mesh = make_he_mesh3(4, limb=2, coeff=2, devices=["cpu"] * 4)
    meng = MeshCKKS(eng.ctx, mesh, rng=tsurf.Surf())
    meng.ring.graphs = graphs.Graphs(StandIn())
    for _ in range(2):
        got = [meng.rs(t["ct2"]), meng.mulpt(t["ct1"], t["pt2"]), meng.rot(t["ct1"], 1, t["rk"])]
        with graphs.disabled():
            want = [eng.rs(t["ct2"]), eng.mulpt(t["ct1"], t["pt2"]),
                    eng.rot(t["ct1"], 1, t["rk"])]
        for a, b in zip(got, want):
            assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
    graphed = {k[0] for k, p in {**meng._fns, **meng.ring._progs}.items() if p.graphs}
    assert {"rs", "he_mulpt"} <= graphed
    assert "gal" not in graphed and any(k[0] == "gal" for k in meng.ring._progs)
    rot = meng._mesh_jit[("rot", t["ct1"].l, 1)]
    assert isinstance(rot, graphs.Program) and len(rot.graphs) == 1
    assert meng.ring.graphs.replays > 0


SMALL = dict(logn=9, q=1 << 120, slots=4, Delta=1 << 30)


@pytest.mark.parametrize("logp,impl", GRAPH_ENGINES)
def test_the_card_checks_run_through_the_stand_in(monkeypatch, logp, impl):
    """torch_cases.graph_check, which the card's tests hold every graphed op
    to eager with, on the CPU at a small ring: the
    engine's default primitive replaced by the stand-in, each op of
    graph_case on two fresh input sets."""
    monkeypatch.setattr(graphs, "CUDA_GRAPHS", StandIn())
    case = graph_case(logp, impl, device="cpu", ring=SMALL)
    inputs = [case["fresh"](seed) for seed in range(2)]
    for op, fn in case["ops"].items():
        graph_check(fn, inputs, op)
    g = case["eng"].ring.graphs
    assert set(case["ops"]) == {op for op in GRAPH_OPS if impl != "matmul" or op not in HOISTED}
    assert g.captures > 0 and g.replays > g.captures


@pytest.mark.parametrize("name,module", [
    ("Memcpy DtoD (Device -> Device)", "copies"), ("Memset (Device)", "copies"),
    ("void ntt_row_pass<7, true>(unsigned long long const*)", "ntt"),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nt_n", "matmul"),
    ("void at::native::index_elementwise_kernel<128, 4>", "other torch")])
def test_profiles_give_a_graphs_copies_a_bucket_of_their_own(name, module):
    """The benchmark's profiles split busy time by module
    (gpubench/devtrace.py); the static inputs' copies and the outputs'
    clones of a graphed op are "copies"."""
    assert kernel_module(name) == module
