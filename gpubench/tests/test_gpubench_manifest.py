"""BENCHMARK.json against the contract the benchmark is checked by, and
every entry found by name under gpubench/."""

import os
import re

import numpy as np
import pytest

from gpubench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "gpubench/run.py"]
    assert MAN["paths"] == ["gpubench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb").read()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and not (group == "per_layer" and key == "source"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    assert len(set(n for _, n in names)) == len(names)


def test_entries_have_just_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert [m["bound"] for m in MAN["end_to_end"] if m["name"] == "setup_s"] == [0.25]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.Cell.load(cell)
    for key in ("kind", "loop", "clients", "pool", "batch", "warmup", "trace_requests",
                "judged", "judge_within"):
        assert key in c.traffic
    assert c.traffic["loop"] == "closed" and c.traffic["clients"] == 1
    assert c.limits["max_err"] > 0
    ref = c.reference
    assert callable(ref.inputs) and callable(ref.circuit)
    assert os.path.exists(os.path.join(harness.HERE, "requests", c.traffic["kind"] + ".py"))
    if "work" in c.traffic:
        assert callable(harness.load_module("work", c.traffic["work"]).reckon)
    for m in c.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


def test_config_files():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["file"].startswith("gpubench/")
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["logq"] // cfg["logDelta"] == cfg["levels"]
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_every_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers <= {"algo", "scheme", "program", "ring", "ops", "kernels", "device", "host"}


def test_four_chip_cells_within_the_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_quantiles_and_rate_over_all_requests():
    rng = np.random.default_rng(0)
    lat = list(rng.lognormal(0, 1, 1001))
    cell = harness.Cell("x", 1, {}, {"batch": 8}, {}, [
        {"name": n, "unit": "u"} for n in ("ct_per_s", "latency_p50_ms", "latency_p95_ms")])
    m = harness.end_to_end(cell, {"requests": 1001, "seconds": 2.0, "latency_ms": lat}, 1.0, 0)
    assert m["latency_p50_ms"]["value"] == float(np.median(lat))
    assert m["latency_p95_ms"]["value"] == float(np.percentile(lat, 95))
    chunks = [np.median(lat[i:i + 100]) for i in range(0, 1001, 100)]
    assert m["latency_p50_ms"]["value"] != float(np.median(chunks))
    assert m["ct_per_s"]["value"] == 1001 * 8 / 2.0


def test_full_check_fits_the_time_limit():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to compile, 1200 s spare, 24 cells
    r = MAN["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200
