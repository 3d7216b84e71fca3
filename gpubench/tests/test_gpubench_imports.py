"""What the benchmark may load: nothing under gpubench/ imports JAX, the
JAX package or chip_smoke, nor reads the JAX package's benchmark; the plain
reference imports nothing of the port.  Top-level module names are compared
whole: gpqhe_tpu_torch is not gpqhe_tpu."""

import ast
import os
import subprocess
import sys

import pytest

from gpubench import harness
from gpubench.run import FORBIDDEN

HERE = os.path.dirname(os.path.abspath(__file__))
NEVER = set(FORBIDDEN) | {"chip_smoke"}
NOT_READ = ("bench.py", "tools/", "BENCH_")


def sources(folder: str = harness.HERE) -> list[str]:
    out = []
    for d, _, files in os.walk(folder):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_nor_chip_smoke(path):
    assert not top_imports(path) & NEVER


@pytest.mark.parametrize("path", [p for p in sources() if not p.startswith(HERE)],
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_the_jax_benchmark_is_not_read(path):
    with open(path) as f:
        text = f.read()
    assert not [s for s in NOT_READ if s in text]


def test_names_are_compared_whole():
    assert {"gpqhe_tpu_torch"} & NEVER == set()
    assert "gpqhe_tpu" in NEVER


@pytest.mark.parametrize("path", sources(os.path.join(harness.HERE, "reference")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert "gpqhe_tpu_torch" not in top_imports(path)


def test_reference_loads_without_the_port():
    code = ("import sys; sys.path.insert(0, %r); from gpubench import harness\n"
            "for k in ('bootstrap', 'cmp', 'gemv_sq', 'mul_rs_batch'):\n"
            "    harness.load_module('reference', k)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'gpqhe_tpu_torch', 'gpqhe_tpu', 'jax'}))"
            % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_loaded_forbidden_compares_top_level_names(monkeypatch):
    from gpubench import run
    monkeypatch.setitem(sys.modules, "gpqhe_tpu_torch_fake", sys)
    assert "gpqhe_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in run.loaded_forbidden()
