"""The control of ``correct``: the same comparison with the computation one
precision below the configuration's bfloat16 must read far above the
program's own reading.

For refinement and serving the control is the program's own int8 path
(``network.quant: int8``); for training it is the reference itself
computed with int8 operands and int8 gradients.  At a test's size on the
CPU (where the program computes in float32) the control must read at
least ten times the program; at the cells' own size on the card, on three
seeds, it must come out not correct under the committed limits.
"""

import json

import pytest
import torch

from conftest import tiny
from portbench import calibrate, run, spec
from test_portbench_faults import CELLS, execute


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def test_refine_control_reads_far_above_the_program():
    """At this size every gap is far under the cell's ``pose_off_at``, so the
    gaps' median is read instead."""
    over = {**tiny("refine"), "limits": {"pose_gap_median": 1.0}}
    readings = []
    for control in ([], ["--control", "int8"]):
        args = run.parse(["--workload", CELLS["refine"], "--seed", "4294967311", "--seconds",
                          "2"] + control)
        res = run.execute(args, torch.device("cpu"), over)
        readings.append(res["checks"]["pose_gap_median"]["value"])
    assert readings[1] >= 10 * max(readings[0], 1e-7)


def test_train_control_reads_far_above_the_program(capsys):
    sound = execute("train")["checks"]
    calibrate.train_controls(CELLS["train"], [4294967311], torch.device("cpu"),
                             tiny("train"))
    lines = [line for line in capsys.readouterr().out.splitlines() if '"control": "fp8"' in line]
    got = json.loads(lines[-1])
    assert got["change_gap"] >= 10 * max(sound["change_gap"]["value"], 1e-7)


@pytest.mark.card
@pytest.mark.parametrize("seed", [91, 92, 93])
@pytest.mark.parametrize("kind", ["refine", "serve"])
def test_control_is_not_correct_at_the_cells_size(kind, seed):
    dev = _card()
    args = run.parse(["--workload", CELLS[kind], "--seed", str(seed), "--seconds", "6",
                      "--control", "int8"])
    assert not run.execute(args, dev)["correct"]


@pytest.mark.card
def test_train_control_is_not_correct_at_the_cells_size(capsys):
    dev = _card()
    calibrate.train_controls(CELLS["train"], [91, 92, 93], dev)
    limits = spec.workload(CELLS["train"])["limits"]
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if '"control": "fp8"' in line]
    assert len(rows) == 3
    for got in rows:
        assert any(got[n] > limit for n, limit in limits.items())
