"""On the card: each cell's control comes out not correct against the
cell's own limits, and the program comes out correct, at the cell's
widths and batch with a short window (one sampled call besides the
longest). Run there with ``python3 -m pytest portbench/tests -m card``."""

import copy

import pytest

from portbench import run

CONTROLS = [("base.offline", "fp8"), ("moe.offline", "fp8"), ("base.train", "fp8")]


def short(workload):
    spec = copy.deepcopy(run.cell(workload))
    if "sample_calls" in spec["mix"]:
        spec["mix"]["sample_calls"] = 1
    return spec


@pytest.mark.card
@pytest.mark.parametrize("workload, control", CONTROLS)
def test_the_control_is_not_correct(card, workload, control):
    out = run.measure(short(workload), 2**31 + 5, 3.0, False, control=control)
    assert out["correct"] is False, out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted({w for w, _ in CONTROLS}))
def test_the_program_is_correct(card, workload):
    out = run.measure(short(workload), 2**31 + 6, 3.0, False)
    assert out["correct"] is True, out["checks"]
