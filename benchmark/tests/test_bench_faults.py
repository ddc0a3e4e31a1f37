"""The check catches a broken timed path: a run driven on the CPU at a
small size, with the program's answers altered where the pipeline
produces them, comes out not correct. (A stereo item is one pair, so no
batch can lose half of itself, and one chip exchanges nothing.)"""

import pytest
import torch
from conftest import CELLS, STREAM, tiny

import run as bench_run
from depthestimation_torch.pipeline import StereoPipeline

ORIGINAL = StereoPipeline.process_pair_async


def _altered(self, left, right):
    """One pixel's disparity one pixel off, one finite depth changed."""
    disp, depth = ORIGINAL(self, left, right)
    disp, depth = disp.clone(), depth.clone()
    disp[disp.shape[0] // 2, disp.shape[1] // 2] += 1.0
    finite = torch.nonzero(torch.isfinite(depth))[0]
    depth[tuple(finite)] *= 2.0
    return disp, depth


def _stale():
    """Every call after the first answers with the previous call's result."""
    last = []

    def fn(self, left, right):
        out = ORIGINAL(self, left, right)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return fn


def _run(cell, monkeypatch, fault):
    monkeypatch.setattr(StereoPipeline, "process_pair_async", fault)
    return bench_run.run(tiny(cell), 2**33 + 5, 1, False, torch.device("cpu"))


@pytest.mark.parametrize("cell", CELLS + (STREAM,))
def test_sound_run_is_correct(cell):
    res = bench_run.run(tiny(cell), 2**33 + 5, 1, False, torch.device("cpu"))
    assert res["correct"] and all(c["value"] == 0.0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS + (STREAM,))
def test_altered_answer_is_not_correct(cell, monkeypatch):
    res = _run(cell, monkeypatch, _altered)
    assert res["correct"] is False
    assert res["checks"]["mismatch_share"]["value"] > res["checks"]["mismatch_share"]["limit"]


@pytest.mark.parametrize("cell", CELLS + (STREAM,))
def test_stale_answer_is_not_correct(cell, monkeypatch):
    res = _run(cell, monkeypatch, _stale())
    assert res["correct"] is False


@pytest.mark.parametrize("cell", CELLS + (STREAM,))
def test_failed_item_is_not_correct(cell, monkeypatch):
    calls = []

    def failing(self, left, right):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("a replay that fails")
        return ORIGINAL(self, left, right)

    res = _run(cell, monkeypatch, failing)
    assert res["failed"] == 1 and res["correct"] is False
