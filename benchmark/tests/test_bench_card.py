"""On the card: a short run of each cell at its own size is correct, and
the control at that size fails the limits. Skips without a card."""

import pytest
from conftest import CELLS

import control
import run as bench_run
from benchlib import spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell, card):
    res = bench_run.run(spec.load_cell(cell), 2**31 + 99, 2, False, card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_size(cell, card):
    c = spec.load_cell(cell)
    c.traffic = dict(c.traffic, sample=2)
    for seed, values in control.readings(c, [7], card).items():
        assert any(values[k] > lim for k, lim in c.limits.items()), values
