"""A mesh that spans processes: the port's counterpart of
tests/test_multiprocess.py.

gpqhe_tpu_torch/parallel/mp_mul_rs.py runs as it would for a user, with
--device=cpu --backend=gloo: two OS processes of 4 mesh positions each, one
(limb, coeff, batch) mesh over both, on (2,2,2) (the limb psum crosses the
processes) and (1,4,2) (the coefficient swap at distance 2 crosses them,
at distance 1 it stays inside one), at logn=6/logq=110/slots=4/Delta=2^30,
on the 59-bit chain and on logp=29.  Rank 0 makes the keys from Surf() and
publishes them; every rank holds its mul_rs, rot(1), conj and fully hoisted
gemv torch.equal to the port's single-device engine (the launcher's PASS).
Here each rank's saved results are held np.array_equal to the JAX package's
single-device CKKS (jitted in this process) on the same keys, loaded through
the JAX package's own serialize.  Beside them, in-process: the
point-to-point schedule of the three collectives, the traffic split by kind
and the launcher's refusals.

Tolerance: none (bit equality), and the ranks' decode diffs < 1e-5.
Budget: the whole file within 60 s on one core of the build host (one
launcher run of ~10 s for both chains; the JAX side's compiles).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpqhe_tpu
from gpqhe_tpu.algo import linalg as jlinalg
from gpqhe_tpu.utils import serialize as jserialize

import gpqhe_tpu_torch as gt
from gpqhe_tpu_torch.parallel import dist as pdist
from gpqhe_tpu_torch.parallel import mesh as tmesh
from gpqhe_tpu_torch.parallel import mp_mul_rs
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
from gpqhe_tpu_torch.utils import serialize

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = dict(logn=6, logq=110, slots=4, logDelta=30)
LAYOUTS = ["2x2x2", "1x4x2"]
_RUN = []
_JAX = {}


def _launch(tmp_path_factory):
    """One launcher run, both chains and both layouts: (rank lines, its
    directory)."""
    if not _RUN:
        out = str(tmp_path_factory.mktemp("mp"))
        argv = ["--device=cpu", "--backend=gloo", "--logp=59,29",
                f"--mesh={','.join(LAYOUTS)}", f"--out={out}", "--timeout=240"]
        p = subprocess.run([sys.executable, "-m", "gpqhe_tpu_torch.parallel.mp_mul_rs", *argv],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, f"stdout:\n{p.stdout[-3000:]}\nstderr:\n{p.stderr[-3000:]}"
        assert p.stdout.splitlines()[-1].startswith("mp_mul_rs: PASS (bit-exact across 2")
        _RUN.append(([json.loads(t) for t in p.stdout.splitlines() if t.startswith("{")], out))
    return _RUN[0]


def _jax_results(logp, out):
    """The JAX package's single-device ops on the published keys."""
    ring = (RING["logn"], 1 << RING["logq"], RING["slots"], 1 << RING["logDelta"])
    ctx = gpqhe_tpu.HeContext(*ring, logp=logp)
    hb = mp_mul_rs.hoist_bits(gt.HeContext(*ring, logp=logp), [(2, 2, 2), (1, 4, 2)])
    eng = gpqhe_tpu.CKKS(ctx, hoist_bits=hb)
    path = lambda name: os.path.join(out, f"logp{logp}", f"{name}.npz")     # noqa: E731
    o = {name: jserialize.load(path(name), ctx) for name in ("rlk", "ck", "ct1", "ct2")}
    rk = {r: jserialize.load(path(f"rk_{r}"), ctx) for r in range(RING["slots"])}
    with np.load(path("messages")) as z:
        plan = jlinalg.HoistedGemvPlan(eng, z["A"])
    return {"mul_rs": eng.mul_rs(o["ct1"], o["ct2"], o["rlk"]),
            "rot": eng.rot(o["ct1"], 1, rk),
            "conj": eng.conj(o["ct1"], o["ck"]),
            "gemv_full": jlinalg.gemv_hoisted_full(eng, plan, o["ct1"], rk)}


@pytest.mark.parametrize("logp", [59, 29])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_process_mesh_matches_jax_and_engine(layout, logp, tmp_path_factory):
    lines, out = _launch(tmp_path_factory)
    if logp not in _JAX:
        _JAX[logp] = _jax_results(logp, out)
    want = _JAX[logp]
    ctx = gt.HeContext(RING["logn"], 1 << RING["logq"], RING["slots"], 1 << RING["logDelta"],
                       logp=logp)
    mine = [ln for ln in lines if ln["mesh"] == layout and ln["logp"] == logp]
    assert sorted(ln["rank"] for ln in mine) == [0, 1]
    for ln in mine:
        assert ln["ranks"] == 2 and ln["backend"] == "gloo" and len(ln["positions"]) == 4
        assert all(ln["equal"].values()) and ln["fallbacks"] == 0
        assert ln["graphed"] is False and "processes" in ln["eager_why"]
        assert all(d < 1e-5 for d in ln["decode_diffs"].values())
        moved = ln["traffic"]["mul_rs"]
        assert sum(kinds["process"][1] for kinds in moved.values()) > 0
        assert all(kinds["device"] == [0, 0] and kinds["staged"] == [0, 0]
                   for t in ln["traffic"].values() for kinds in t.values())
        # which collective crosses the processes is the layout's
        crossing = {c for c, kinds in moved.items() if kinds["process"][0]}
        assert crossing == ({"psum", "gather"} if layout == "2x2x2" else
                            {"ppermute", "gather"}) - ({"gather"} if ln["rank"] == 0 and
                                                        layout == "2x2x2" else set())
        for op, w in want.items():
            got = serialize.load(os.path.join(out, f"logp{logp}", f"res_{layout}_{op}_rank"
                                                              f"{ln['rank']}.npz"), ctx, device="cpu")
            assert (got.l, got.nu, got.B) == (w.l, w.nu, w.B), op
            assert np.array_equal(limbs_to_numpy(got.c0), np.asarray(w.c0)), op
            assert np.array_equal(limbs_to_numpy(got.c1), np.asarray(w.c1)), op


# -- in-process: the schedule, the traffic, the launcher's refusals ------------

def _recorded_moves(layout, monkeypatch):
    """The move lists of every collective step on a one-process mesh of this
    layout (a psum, the coefficient swaps, a gather): [(collective, moves)]."""
    L, S, B = layout
    mesh = tmesh.make_he_mesh3(L * S * B, limb=L, coeff=S, devices=["cpu"] * (L * S * B))
    steps = []
    real = tmesh._transfer

    def record(mesh_, values, moves, collective, like):
        steps.append((collective, list(moves)))
        return real(mesh_, values, moves, collective, like)
    vals = {pos: torch.full((3,), float(sum(pos))) for pos in mesh.positions}
    monkeypatch.setattr(tmesh, "_transfer", record)
    tmesh._psum_limb(mesh, vals)
    for d in (1, 2)[:S.bit_length() - 1]:
        tmesh._ppermute_coeff_xor(mesh, vals, d)
    spec = ("batch", "coeff", None)
    tmesh._gather(mesh, tmesh._scatter(mesh, torch.zeros(B, 8 * S, 2), spec), spec)
    return mesh, steps


@pytest.mark.parametrize("layout", [(2, 2, 2), (1, 4, 2)], ids=["2x2x2", "1x4x2"])
def test_p2p_schedule_is_the_same_on_every_rank_and_pairs_up(layout, monkeypatch):
    """Two ranks of 4 positions (rank = position index // 4, as the all-gather
    in rank order makes them): every move of every step is local to one rank
    or one send matched by one receive, and between two ranks the sends of
    one come in the order of the other's receives, so a step posted at once
    cannot deadlock."""
    mesh, steps = _recorded_moves(layout, monkeypatch)
    rank_of = {pos: i // 4 for i, pos in enumerate(mesh.positions)}
    crossing = set()
    for collective, moves in steps:
        sched = {r: pdist.schedule(rank_of.get, moves, r) for r in (0, 1)}
        for move in moves:
            a, b = rank_of[move[0]], rank_of[move[1]]
            if a == b:
                assert [e for e in sched[a] if e[2] == move] == [("local", a, move)]
                assert all(e[2] != move for e in sched[1 - a])
            else:
                assert ("send", b, move) in sched[a] and ("recv", a, move) in sched[b]
                crossing.add((collective, abs(move[0][1] - move[1][1])))
        for a, b in ((0, 1), (1, 0)):
            sent = [m for op, peer, m in sched[a] if op == "send" and peer == b]
            received = [m for op, peer, m in sched[b] if op == "recv" and peer == a]
            assert sent == received
    if layout == (2, 2, 2):
        assert ("psum", 0) in crossing and not any(c == "ppermute" for c, _ in crossing)
    else:           # the swap at distance 2 crosses, the one at distance 1 does not
        assert ("ppermute", 2) in crossing and ("ppermute", 1) not in crossing
        assert not any(c == "psum" for c, _ in crossing)


def test_traffic_by_kind():
    """Views on one device, copies between two; traffic sums the kinds."""
    mesh = tmesh.make_he_mesh3(8, limb=2, coeff=2, devices=["cpu"] * 8)
    x = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    parts = tmesh._scatter(mesh, x, ("batch", "coeff", None))
    tmesh._psum_limb(mesh, parts)
    t = mesh.traffic_by_kind
    assert t["scatter"]["view"] == [8, 8 * 18 * 8] and t["psum"]["view"] == [8, 8 * 18 * 8]
    assert all(t[c][k] == [0, 0] for c in t for k in ("device", "process", "staged"))
    assert mesh.traffic["scatter"] == [8, 8 * 18 * 8] and mesh.traffic["ppermute"] == [0, 0]
    two = tmesh.make_he_mesh3(2, limb=2, devices=["cpu", "meta"])
    moved = tmesh._move(two, torch.ones(5, dtype=torch.int64), (1, 0, 0), "gather")
    assert moved.device.type == "meta"
    assert two.traffic_by_kind["gather"]["device"] == [1, 40]
    assert two.traffic["gather"] == [1, 40]
    two.reset_traffic()
    assert two.traffic["gather"] == [0, 0]


def test_launcher_refuses_nccl_without_a_card_per_rank():
    with pytest.raises(SystemExit, match="needs a card per rank"):
        mp_mul_rs.main(["--device=cpu", "--backend=nccl"])
    with pytest.raises(SystemExit, match="divides by --ranks=3"):
        mp_mul_rs.main(["--device=cpu", "--backend=gloo", "--ranks=3"])


def test_launcher_kills_the_other_ranks_when_one_fails():
    fail = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])
    hang = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    assert mp_mul_rs._wait_all([fail, hang], timeout=60) == [3, None]
    assert hang.poll() is not None                   # killed, not left running
    slow = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    assert mp_mul_rs._wait_all([slow], timeout=0.5) == [None]
    assert slow.poll() is not None
