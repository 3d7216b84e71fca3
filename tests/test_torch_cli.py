"""The port's per-op CLI against the JAX package's.

`gpqhe_tpu_torch.cli.main([...,"--device=cpu"])` and `gpqhe_tpu.cli.main`
run the same op at the same small ring from the same surf stream: they must
print the same lines (context dump, progress, `[ok] <op>: diff = ...` with
the same digits, since the ciphertexts are bit-equal; `[FAIL]` alike where
the op misses its tolerance) and return the same exit code.  Only the `total ...s` line, the wall time, differs.  A bad op prints the
usage and returns 1; --mesh=LxSxB wants that many distinct devices and returns
2 with the JAX CLI's message where there are fewer, --mesh=LxSxB:virtual
repeats the one --device; without --device=cpu the engine wants the GPU and
raises where there is none.
"""

import pytest
import torch

from gpqhe_tpu import cli as jcli
from gpqhe_tpu_torch import cli as tcli

torch.set_num_threads(1)

SMALL = ["--logn=5", "--logq=100", "--slots=2", "--logDelta=30"]
CASES = {
    "ecd": ["ecd"] + SMALL,
    "enc_sk": ["enc", "sk"] + SMALL,
    "enc_pk": ["enc", "pk"] + SMALL,
    "mul_pk": ["mul", "pk"] + SMALL,
    "rot": ["rot"] + SMALL,
    "exp": ["exp", "--logn=5", "--logq=190", "--slots=2", "--logDelta=30", "--iter=1"],
    # two iterations are too few for the square root: both must say FAIL and return 2
    "sqrt_fails": ["sqrt", "--logn=5", "--logq=190", "--slots=2", "--logDelta=30", "--iter=2"],
}


def _lines(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out.splitlines()
    return rc, [ln for ln in out if not ln.startswith("total ")]      # the wall time


@pytest.mark.parametrize("case", list(CASES))
def test_cli_prints_the_same_as_jax(capsys, case):
    argv = CASES[case]
    rc_j, out_j = _lines(capsys, jcli.main, argv)
    rc_t, out_t = _lines(capsys, tcli.main, argv + ["--device=cpu"])
    assert rc_t == rc_j == (2 if case.endswith("_fails") else 0)
    assert out_t == out_j
    marks = [ln for ln in out_t if ln.startswith("[")]
    assert marks and all(ln.startswith("[FAIL] " if rc_t else "[ok] ") for ln in marks)


def test_cli_logp29_chain(capsys):
    rc, out = _lines(capsys, tcli.main, CASES["mul_pk"] + ["--device=cpu", "--logp=29"])
    assert rc == 0 and any(ln.startswith("[ok] mul: diff = ") for ln in out)
    assert any("(30 bits)" in ln for ln in out)


def test_cli_defaults_match():
    for op in tcli.OPS:
        pj, pt = jcli.set_params(op, []), tcli.set_params(op, [])
        for key in ("logn", "logq", "slots", "logDelta", "iter", "alpha", "idx"):
            assert pj[key] == pt[key], (op, key)
        assert pt["device"] == "cuda" and pt["logp"] == 59 and pt["mesh"] is None
        assert pt["mesh_virtual"] is False
    assert tcli.OPS == jcli.OPS and len(tcli.OPS) == 19


def test_cli_usage_on_a_bad_op(capsys):
    assert tcli.main(["frobnicate"]) == 1
    out = capsys.readouterr().out
    assert out.startswith("usage: python -m gpqhe_tpu_torch <ecd/enc/") and "--device=cuda|cpu" in out
    assert tcli.main([]) == 1
    capsys.readouterr()
    assert tcli.main(["ecd", "--device=tpu"]) == 1


def test_cli_refuses_a_mesh(capsys):
    """A mesh of distinct devices on a machine that has fewer: the message of
    the JAX CLI, the port's way to a virtual mesh in place of XLA's flag,
    exit code 2 and no silent single-device run."""
    assert tcli.main(["mul", "--mesh=2x2x2", "--device=cpu"] + SMALL) == 2
    out = capsys.readouterr().out
    assert "--mesh=2x2x2 needs 8 devices; this session has 1." in out
    assert "--mesh=2x2x2:virtual" in out and "[ok]" not in out and "mesh mode" not in out
    if torch.cuda.device_count() < 8:
        assert tcli.main(["mul", "--mesh=2x2x2"] + SMALL) == 2
        assert f"this session has {torch.cuda.device_count()}." in capsys.readouterr().out
    for bad in ("--mesh=2x2", "--mesh=2x2x1:real", "--mesh=0x1x1"):
        with pytest.raises(ValueError, match="LIMBxCOEFFxBATCH"):
            tcli.main(["mul", bad, "--device=cpu"] + SMALL)


@pytest.mark.parametrize("op", ["mul", "rot"])
def test_cli_virtual_mesh(capsys, op):
    """--mesh=2x2x1:virtual --device=cpu: the JAX CLI's `mesh mode` line, the
    same [ok] lines with the same digits as the single-device run (the
    ciphertexts are bit-equal), and for rot the sharded programs built."""
    argv = [op, "pk"] + SMALL + ["--device=cpu"]
    rc_s, out_s = _lines(capsys, tcli.main, argv)
    rc_m, out_m = _lines(capsys, tcli.main, argv + ["--mesh=2x2x1:virtual"])
    assert rc_s == rc_m == 0
    assert out_m[0] == "mesh mode: {'limb': 2, 'coeff': 2, 'batch': 1}"
    built = [ln for ln in out_m if ln.startswith("mesh programs built: ")]
    assert len(built) == 1 and (("('rot', 3, 1)" in built[0]) == (op == "rot"))
    assert [ln for ln in out_m[1:] if ln not in built] == out_s
    assert any(ln.startswith("[ok] ") for ln in out_m)


def test_cli_wants_the_gpu_by_default(capsys):
    if torch.cuda.is_available():
        assert tcli.main(["ecd"] + SMALL) == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["ecd"] + SMALL)
    capsys.readouterr()
