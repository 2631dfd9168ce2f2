"""deepim_tpu_torch.utils' logging and profiling helpers against
deepim_tpu.utils' (CPU): the cases of tests/test_utils.py for
``PrintAndLog``, ``MetricsLogger``, ``StageTimer`` and ``Speedometer``
(the same lines, records and log text as the reference's), plus ``stage``
and ``trace`` through ``torch.profiler``.
"""

import json
import os
import re

import numpy as np
import torch

from deepim_tpu.utils import profiling as prof_j
from deepim_tpu_torch.utils import (
    MetricsLogger, PrintAndLog, Speedometer, StageTimer, mkdir_if_missing, stage, trace)


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


def test_stage_timer():
    t = StageTimer()
    with t.time("matmul") as box:
        box["result"] = torch.ones(64, 64) @ torch.ones(64, 64)
    with t.time("matmul", result={"a": [torch.zeros(2)]}):
        pass
    with t.time("host"):
        pass
    assert t.counts["matmul"] == 2 and t.counts["host"] == 1
    lines = t.summary().splitlines()
    assert len(lines) == 2 and all(re.search(r"ms/call  x\d+ = ", ln) for ln in lines)
    ref = prof_j.StageTimer()
    ref.totals, ref.counts = t.totals, t.counts
    assert ref.summary() == t.summary()  # the reference's table, line for line
    t.reset()
    assert not t.totals and not t.counts


def test_speedometer():
    logs, logs_j = [], []
    items = list(Speedometer(range(10), batch_size=4, every=5, log=logs.append))
    list(prof_j.Speedometer(range(10), batch_size=4, every=5, log=logs_j.append))
    assert [i for i, _ in items] == list(range(10))
    assert len(logs) == 2 and "samples/s" in logs[0]
    pattern = re.compile(r"^\[speedometer\] step (5|10): [\d.]+ samples/s$")
    assert all(pattern.match(a) and pattern.match(b) for a, b in zip(logs, logs_j))


def test_stage_and_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        with stage("render"):
            torch.ones(8, 8).sum()
    data = json.load(open(tmp_path / "tr" / "trace.json"))
    assert any(e.get("name") == "render" for e in data["traceEvents"])
    assert mkdir_if_missing(str(tmp_path / "a" / "b")) == str(tmp_path / "a" / "b")
    assert os.path.isdir(tmp_path / "a" / "b")
