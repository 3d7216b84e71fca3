"""A run with the timed path broken underneath must come out not correct:
the harness (all but its look for a card) on the CPU at small rings, with
each fault a cell can have planted in the program: a step that returns its
input unchanged, half of a batch left out (its outputs copies of the other
half), and an answer altered where it is produced.  The cells run on one
chip, so no exchange between chips can be left out."""

import pytest
import torch

from gpqhe_tpu_torch import bootstrap as bs
from gpqhe_tpu_torch.algo import linalg, nonlinear
from gpqhe_tpu_torch.scheme.engine import CKKS

from gpubench.tests import tiny


def altered(ct):
    """The ciphertext with its constant coefficient moved by a tenth of the
    scale: every slot moves by ~0.1."""
    c0 = ct.c0.clone()
    c0[0, 0] = (c0[0, 0] + int(ct.nu) // 10) & 0xFFFFFFFF
    out = ct.copy()
    out.c0 = c0
    return out


def batch_unchanged(self, cts1, cts2, rlk):
    return list(cts1)


def batch_half(self, cts1, cts2, rlk, _orig=CKKS.mul_rs_batch):
    h = len(cts1) // 2
    first = _orig(self, cts1[:h], cts2[:h], rlk)
    return first + first[:len(cts1) - h]


def batch_altered(self, cts1, cts2, rlk, _orig=CKKS.mul_rs_batch):
    out = _orig(self, cts1, cts2, rlk)
    return out[:-1] + [altered(out[-1])]


FAULTS = {
    ("mul_rs_batch", "unchanged"): (CKKS, "mul_rs_batch", batch_unchanged),
    ("mul_rs_batch", "half_batch"): (CKKS, "mul_rs_batch", batch_half),
    ("mul_rs_batch", "altered"): (CKKS, "mul_rs_batch", batch_altered),
    ("gemv_sq", "unchanged"): (linalg, "gemv_hoisted_full", lambda eng, plan, ct, rk: ct),
    ("gemv_sq", "altered"): (CKKS, "addpt", lambda self, ct, pt, _o=CKKS.addpt:
                             altered(_o(self, ct, pt))),
    ("cmp", "unchanged"): (nonlinear, "he_cmp", lambda eng, a, b, rlk, iter, alpha: a),
    ("cmp", "altered"): (nonlinear, "he_cmp", lambda eng, a, b, rlk, iter, alpha,
                         _o=nonlinear.he_cmp: altered(_o(eng, a, b, rlk, iter=iter,
                                                         alpha=alpha))),
    ("bootstrap", "unchanged"): (bs, "bootstrap", lambda eng, bctx, ct, *a, **k: ct),
    ("bootstrap", "altered"): (bs, "bootstrap", lambda *a, _o=bs.bootstrap, **k:
                               altered(_o(*a, **k))),
}


@pytest.mark.parametrize("kind, fault", sorted(FAULTS), ids=lambda x: x)
def test_a_broken_timed_path_is_not_correct(kind, fault, monkeypatch):
    owner, name, broken = FAULTS[kind, fault]
    monkeypatch.setattr(owner, name, broken)
    r = tiny.run(tiny.cell(kind))
    assert r["correct"] is False
    assert r["failed"] >= 1


def test_the_sound_path_is_correct_beside_them():
    assert tiny.run(tiny.cell("mul_rs_batch"))["correct"] is True
    assert torch.get_num_threads() >= 1
