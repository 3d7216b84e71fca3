"""The control of each cell (the plain reference in the nearest precision
below the configuration's, in the program's place) must come out not
correct against the cell's limits, on several seeds: on the CPU here, and
on the card with the circuit computed there."""

import pytest

from gpubench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEEDS = (11, 2**31 + 7, 3_000_000_019)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    c = harness.Cell.load(cell)
    r = harness.control(c, seed)
    assert not harness.correct(r["checks"]), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_not_correct(cell, seed, card):
    c = harness.Cell.load(cell)
    r = harness.control(c, seed, str(card))
    assert not harness.correct(r["checks"]), r["checks"]
