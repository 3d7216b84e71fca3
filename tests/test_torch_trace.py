"""The port's spans and counters (gpqhe_tpu_torch/utils/trace.py), recorded
where the work happens: off, a span point is the shared null context; under
op_trace() a bootstrap records its stages, its encodes (their limbs filled
on the device) and the bytes it copies there; under torch.profiler the same spans are host ranges
and the program calls as many as the op trace counts; a program's first
call adds to the set-up totals.

Jax-free, so that the card's test (marked `cuda`) runs there with
`python -m pytest tests/test_torch_trace.py --noconftest -m cuda -q`.  The
ring is tests/test_torch_bootstrap_e2e.py's smoke ring (logn=4, q=2^610,
slots=2, Delta=2^30): one bootstrap takes under a second on the CPU.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch import bootstrap as bs
from gpqhe_tpu_torch.substrate.surf import Surf
from gpqhe_tpu_torch.utils import graphs, trace

torch.set_num_threads(1)

SMOKE = dict(logn=4, q=1 << 610, slots=2, Delta=1 << 30)
STAGES = {"bootstrap.raise_modulus": 1, "bootstrap.subsum": 1, "bootstrap.coeff2slot": 1,
          "bootstrap.evalsin": 2, "bootstrap.exp": 2, "bootstrap.slot2coeff": 1}


def _bootstrap_setup(device):
    """Keys, a level-1 ciphertext and a bootstrap already run once (its
    programs built, its plans' diagonals encoded): (engine, bootstrap,
    coeff2slot of the raised ciphertext)."""
    ctx = gt.HeContext(**SMOKE)
    eng = gt.CKKS(ctx, rng=Surf(), device=device)
    pk, sk = eng.keypair()
    keys = dict(rlk=eng.genrlk(sk), ck=eng.genck(sk),
                rk=eng.genrk(sk, bs.bootstrap_rotations(ctx)))
    ct = eng.enc_pk(eng.ecd(np.array([0.1 + 0.05j, -0.05])), pk)
    while ct.l > 1:
        ct = eng.moddown(ct)
    bctx = bs.BootstrapContext(eng)

    def run():
        return bs.bootstrap(eng, bctx, ct, keys["rlk"], keys["ck"], keys["rk"])

    def c2s():
        raised = bs.raise_modulus(eng, ct, nu=eng.Delta)
        return bs.coeff2slot(eng, bctx, raised, keys["ck"], keys["rk"])
    run()
    return eng, run, c2s


@pytest.fixture(scope="module")
def boot():
    return _bootstrap_setup("cpu")


def _h2d_bytes(eng) -> int:
    """raise_modulus's modulus limbs: the bootstrap's 19 constant plaintexts
    (15 const_pt, 4 ecd) are filled on the device from their nonzero rows,
    with no copy."""
    return eng.kq * 8


def test_a_span_is_the_shared_null_context_when_nothing_records(boot):
    eng, run, _ = boot
    assert not trace.on()
    assert trace.span("x") is trace.NULL
    assert trace.span("replay.he_mul", torch.device("cpu"), "he_mul") is trace.NULL
    with trace.op_trace():
        pass
    last, h2d = trace.last(), dict(trace.H2D)
    with trace.span("x"):
        run()
    assert trace.last() is last and not last.spans and not last.counts
    # the bytes count whether or not anything traces
    assert trace.H2D["bytes"] - h2d["bytes"] == _h2d_bytes(eng)
    # the engine hands out its cached programs themselves: no wrapper
    assert not hasattr(trace, "maybe_wrap")
    assert eng.mul_step_fn(1) is eng._fns[("he_mul", 1)]


def test_op_trace_of_a_bootstrap_records_its_stages_encodes_and_copies(boot):
    eng, run, _ = boot
    with trace.op_trace() as t:
        run()
    assert trace.last() is t
    n = {k: len(v) for k, v in t.spans.items()}
    assert {k: n.get(k) for k in STAGES} == STAGES
    assert (n["ckks.const_pt"], n["ckks.ecd"], n["ckks.h2d"]) == (15, 4, 1)
    assert t.counter(trace.H2D) == {"bytes": _h2d_bytes(eng), "copies": 1}
    assert t.counter(trace.ENCODE) == {"on_card": 19}
    # every program call is a replay span under its head; on the CPU every
    # time is the host's and none the device's
    heads = {k[len("replay."):]: v for k, v in n.items() if k.startswith("replay.")}
    assert heads == t.counts and sum(heads.values()) > 100
    assert all(h > 0 and d is None for recs in t.spans.values() for h, d in recs)
    assert t.device_s is None and set(t.seconds) == set(t.counts)
    # the stages nest: subsum inside coeff2slot, exp inside evalsin
    host = {k: sum(h for h, _ in v) for k, v in t.spans.items()}
    assert host["bootstrap.subsum"] < host["bootstrap.coeff2slot"]
    assert host["bootstrap.exp"] < host["bootstrap.evalsin"]


def test_the_profiler_sees_the_ports_spans_as_host_ranges(boot):
    """The bootstrap's first two stages under torch.profiler and op_trace at
    once: the same spans, each a host range (the profiler's own event
    records: its EventList takes half a minute to build for these)."""
    _, _, c2s = boot
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.op_trace() as t:
        c2s()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith(
                ("replay.", "capture.", "bootstrap.", "ckks.", "linalg.")):
            ranges[e.name()] = ranges.get(e.name(), 0) + 1
    spans = {k: len(v) for k, v in t.spans.items()}
    assert ranges == spans
    assert {k: ranges.get(k) for k in ("bootstrap.raise_modulus", "bootstrap.subsum",
                                       "bootstrap.coeff2slot", "ckks.const_pt", "ckks.h2d",
                                       "linalg.gemv")} == {
        "bootstrap.raise_modulus": 1, "bootstrap.subsum": 1, "bootstrap.coeff2slot": 1,
        "ckks.const_pt": 1, "ckks.h2d": 1, "linalg.gemv": 4}
    progs = {k[len("replay."):]: v for k, v in ranges.items() if k.startswith("replay.")}
    assert progs == t.counts and not any(k.startswith("capture.") for k in ranges)


def test_first_calls_are_captures_and_set_up_time():
    """A program's first call is a capture span and adds its host seconds to
    trace.SETUP; later calls are replays (the capture primitive's stand-in
    on the CPU, tests/torch_standin.py)."""
    from torch_standin import StandIn
    g = graphs.Graphs(StandIn())
    prog = g.program(lambda x: x * 2, ("twice", 3))
    before = dict(trace.SETUP)
    x = torch.arange(4)
    with trace.op_trace() as t:
        prog(x)
        prog(x)
        prog(x + 1)
    assert {k: len(v) for k, v in t.spans.items()} == {"capture.twice": 1, "replay.twice": 2}
    assert t.counts == {"twice": 3}
    assert trace.SETUP["captures"] == before["captures"] + 1
    assert trace.SETUP["capture_s"] > before["capture_s"]
    named = g.program(lambda x: x + 1, ("sharded_x", 1), name="swk")
    with trace.op_trace() as t:
        named(x)
        named(x)
    assert t.counts == {"swk": 2} and set(t.spans) == {"capture.swk", "replay.swk"}


def test_switch_keys_are_keygen_time_outside_first_calls():
    ctx = gt.HeContext(logn=5, q=1 << 100, slots=2, Delta=1 << 30)
    eng = gt.CKKS(ctx, rng=Surf(), device="cpu")
    _, sk = eng.keypair()
    before = dict(trace.SETUP)
    t0 = time.perf_counter()
    with trace.op_trace() as t:
        eng.genck(sk)
        eng.genrk(sk, [1])
    wall = time.perf_counter() - t0
    assert len(t.spans["ckks.genswk"]) == 2
    assert 0 < trace.SETUP["keygen_s"] - before["keygen_s"] <= wall
    assert trace.SETUP["capture_s"] == before["capture_s"]      # nothing graphed on the CPU


@pytest.mark.cuda
def test_on_the_card_counted_copies_are_the_host_to_device_copies():
    """One bootstrap's counted copies equal the Memcpy HtoD operations of a
    profiler capture of it; under op_trace every span has a device time and
    the top-level stages lie inside the block's; a span inside a program's
    capture records no event (the capture would fail, or hold it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with `python -m pytest tests/test_torch_trace.py "
                    "--noconftest -m cuda`")
    dev = torch.device("cuda", 0)
    eng, run, _ = _bootstrap_setup(dev)
    torch.cuda.synchronize()
    before = trace.H2D["copies"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    copies = trace.H2D["copies"] - before
    htod = [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name.startswith("Memcpy HtoD")]
    assert copies == 1 and len(htod) == copies, htod

    trace._FREE.pop(dev, None)          # an empty pool, as in a new process
    with trace.op_trace() as t:
        # the pool was made before the block's first event (its own)
        assert len(trace._FREE[dev]) == trace.POOL - 1
        run()
    host_only = {"ckks.ecd", "ckks.const_pt"}          # the host's build of limbs
    assert all((d is None) == (k in host_only) and (d is None or d > 0)
               for k, recs in t.spans.items() for _, d in recs)
    top = sum(d for k in ("bootstrap.raise_modulus", "bootstrap.coeff2slot",
                          "bootstrap.evalsin", "bootstrap.slot2coeff")
              for _, d in t.spans[k])
    assert 0 < top <= t.device_s
    assert sum(d for _, d in t.spans["bootstrap.subsum"]) < top

    def fn(x):
        with trace.span("inside", x.device):
            return x * 3 + 1
    prog = eng.ring.graphs.program(fn, ("inside_capture",))
    x = torch.arange(8, device=dev)
    with trace.op_trace() as t:
        first = prog(x)
        again = prog(x)
    assert torch.equal(first, x * 3 + 1) and torch.equal(again, first)
    # the warm-up and the capture ran it, neither recording an event
    assert [d for _, d in t.spans["inside"]] == [None, None]
    assert t.spans["capture.inside_capture"][0][1] > 0
    assert t.spans["replay.inside_capture"][0][1] > 0
