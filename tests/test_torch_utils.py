"""deepim_tpu_torch.utils' logging and profiling helpers (CPU): the cases
of tests/test_utils.py for ``PrintAndLog`` and ``MetricsLogger``, plus
``stage`` and ``trace`` through ``torch.profiler`` (the spans themselves
are tests/test_torch_spans.py's).
"""

import json
import os

import numpy as np
import torch

from deepim_tpu_torch.utils import MetricsLogger, PrintAndLog, mkdir_if_missing, stage, trace


def test_print_and_log(tmp_path, capsys):
    log = PrintAndLog(str(tmp_path / "sub" / "log.txt"))
    log("hello", 42)
    log("again")
    assert "hello 42" in capsys.readouterr().out
    assert open(tmp_path / "sub" / "log.txt").read() == "hello 42\nagain\n"


def test_metrics_logger(tmp_path):
    m = MetricsLogger(str(tmp_path / "m.jsonl"))
    m.write(1, {"loss": np.float32(0.5), "name": "x", "t": torch.tensor(0.25)})
    m.write(2, {"loss": 0.25})
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert recs[0]["loss"] == 0.5 and recs[0]["name"] == "x" and recs[0]["t"] == 0.25
    assert recs[1]["step"] == 2 and set(recs[1]) == {"step", "time", "loss"}


def test_stage_and_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        with stage("render"):
            torch.ones(8, 8).sum()
    data = json.load(open(tmp_path / "tr" / "trace.json"))
    assert any(e.get("name") == "render" for e in data["traceEvents"])
    assert mkdir_if_missing(str(tmp_path / "a" / "b")) == str(tmp_path / "a" / "b")
    assert os.path.isdir(tmp_path / "a" / "b")
