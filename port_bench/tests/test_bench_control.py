"""The control comes out not correct: the reference one precision below the
configuration's (fp8 operands for bfloat16, TF32 products for float32) put in
the program's place fails at least one of the cell's limits. At narrow widths
here, where only the control is judged (the limits were set from the program's
readings at each cell's own size, which ``control.py`` reads on the card); TF32
exists on the card alone, so the float32 cell's test needs it.

The window runs on a clock that advances 10 ms at each reading, so the requests
served, and the sample the check keeps, do not depend on the host's speed.
``flagship.request-b1`` compares the lane at the 75th percentile, which narrow
widths do not separate from fp8 on every seed: its test runs at the cell's own
widths and weights, on a pool of 4 requests."""

import itertools
import types

import pytest
import torch

import tiny
from port_bench import check, harness


@pytest.fixture(autouse=True)
def steady_clock(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(harness, "time",
                        types.SimpleNamespace(perf_counter=lambda: 0.01 * next(ticks)))


def control_checks(cell_name, device, narrow=True):
    bench = tiny.bench()
    spec = {w["name"]: w for w in bench["workloads"]}[cell_name]
    if narrow:
        config, traffic = tiny.config(spec["config"]), tiny.traffic(spec["traffic"])
    else:
        config = harness.load_json(harness.HERE, "configs", spec["config"] + ".json")
        traffic = dict(harness.load_json(harness.HERE, "traffic", spec["traffic"] + ".json"),
                       pool=4)
    cell = harness.Cell(bench, cell_name, config=config, traffic=traffic)
    result = harness.run_cell(cell, 2**31 + 4242, 0.3, False, device=device, control=True)
    return check.judge(result["control"], cell.limits), result


@pytest.mark.parametrize("cell_name", ["flagship.synth-batch32", "flagship-init.train-batch32"])
def test_the_fp8_control_is_not_correct(cell_name):
    checks, _ = control_checks(cell_name, "cpu")
    assert not check.passed(checks), checks


def test_the_fp8_control_is_not_correct_at_batch_1():
    checks, result = control_checks("flagship.request-b1", "cpu", narrow=False)
    assert result["correct"], result["checks"]
    assert not check.passed(checks), checks


@pytest.mark.card
def test_the_tf32_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("TF32 products exist on the card only")
    checks, result = control_checks("streaming.synth-batch64", "cuda")
    assert result["correct"], result["checks"]
    assert not check.passed(checks), checks
