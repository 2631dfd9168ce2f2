"""The readers of the program's spans (``portbench/spans.py`` and the five
metrics on it) on hand-made spans and device intervals with known
answers, then in traced runs of tiny cells on the CPU."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, tiny
from portbench import run, spans, spec, trace
from test_portbench_spec import _add_cell, _copy

from deepim_tpu_torch.utils.profiling import Span, clear_spans

REFINE = ("refine.raster_front_idle_share", "refine.host_syncs_per_call")
TRAIN = ("train.synthesis_idle_share", "train.host_syncs_per_step", "train.launch_idle_share")


def _span(name, i, parent, root, start, end, syncs=0):
    return Span(name, i, parent, root, {}, start, end, syncs)


def _run(device, window_ns=100):
    return SimpleNamespace(trace={"device": [(s, e, "k") for s, e in device],
                                  "window_s": window_ns / 1e9})


def _read(name, got, device, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: got)
    return spec.reader(name)(_run(device))


# Two refine calls.  Call 1: pack [10, 20] and bin [20, 30] under a render,
# then a second render whose bin [70, 80] has no device work; call 2 is
# [100, 100] long.  Two streams overlap on [16, 18].
REFINE_SPANS = [
    _span("refine_poses", 1, None, 1, 0, 90, syncs=1),
    _span("refine.iter", 2, 1, 1, 0, 90),
    _span("render", 3, 2, 1, 10, 60),
    _span("render.pack", 4, 3, 1, 10, 20),
    _span("render.bin", 5, 3, 1, 20, 30, syncs=2),
    _span("render.raster", 6, 3, 1, 30, 40),
    _span("render", 7, 2, 1, 65, 85),
    _span("render.bin", 8, 7, 1, 70, 80),
    _span("refine_poses", 9, None, 9, 90, 100),
]
REFINE_DEVICE = [(15, 18), (16, 25), (35, 70)]

# One training step: synthesis [0, 40] with its render [10, 30], then the
# rest of the step [40, 100] with a backward [60, 90].
TRAIN_SPANS = [
    _span("train.step", 1, None, 1, 0, 100, syncs=1),
    _span("train.synthesis", 2, 1, 1, 0, 40),
    _span("render", 3, 2, 1, 10, 30, syncs=3),
    _span("train.backward", 4, 1, 1, 60, 90),
]
TRAIN_DEVICE = [(5, 15), (12, 20), (50, 90)]


@pytest.mark.parametrize("name,want", [
    # pack [10, 20] busy [15, 20]; bin [20, 30] busy [20, 25]; bin [70, 80] idle
    ("refine.raster_front_idle_share", 20.0),
    ("refine.host_syncs_per_call", 1.5),
    # [0, 40] against [5, 20]: 25 idle
    ("train.synthesis_idle_share", 25.0),
    ("train.host_syncs_per_step", 4.0),
    # [40, 100] against [50, 90]: 20 idle
    ("train.launch_idle_share", 20.0),
])
def test_readers_on_known_spans(name, want, monkeypatch):
    got, device = ((REFINE_SPANS, REFINE_DEVICE) if name.startswith("refine")
                   else (TRAIN_SPANS, TRAIN_DEVICE))
    assert _read(name, got, device, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("name", REFINE + TRAIN)
def test_readers_read_nothing_without_spans(name, monkeypatch):
    for got in (None, []):  # a program without the facility; nothing recorded
        assert _read(name, got, REFINE_DEVICE, monkeypatch) is None
    other = REFINE_SPANS if name.startswith("train") else TRAIN_SPANS
    assert _read(name, other, REFINE_DEVICE, monkeypatch) is None


def test_an_overflowed_buffer_reads_nothing(monkeypatch):
    from deepim_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: tuple(REFINE_SPANS))
    assert spans.program_spans() == REFINE_SPANS
    monkeypatch.setattr(profiling, "dropped_spans", lambda: 1)
    assert spans.program_spans() is None


def test_idle_by_innermost_span_adds_up():
    table = spans.idle_by_innermost(REFINE_SPANS, [(s, e, "k") for s, e in REFINE_DEVICE],
                                    -10, 110)
    assert table["render.pack"] == pytest.approx(5e-9)
    assert table["render.bin"] == pytest.approx(15e-9)
    assert table["render.raster"] == pytest.approx(5e-9)  # busy [35, 40]
    assert table[spans.OUTSIDE] == pytest.approx(20e-9)
    busy = sum(e - s for s, e in spans.union(REFINE_DEVICE))
    assert sum(table.values()) == pytest.approx((120 - busy) / 1e9)


def test_interval_arithmetic():
    a = spans.union([(5, 9), (0, 3), (2, 4), (9, 9)])
    assert a == [(0, 4), (5, 9)]
    assert spans.minus(a, [(1, 2), (3, 6)]) == [(0, 1), (2, 3), (6, 9)]
    assert spans.overlap(a, [(1, 2), (3, 6)]) == 3
    assert spans.idle_ns(a, [(3, 6)]) == 6


def test_traced_tiny_refine_cell_reports_its_span_metrics(tmp_path):
    """Through a copy with a tiny refine cell added (test_portbench_spec's
    mechanism): the refine metrics are there in a traced run, and a program
    without ``profiling.spans`` (the parent's) leaves them out unharmed.
    The stretch opens with the first call, however slow the CPU is."""
    root = _copy(tmp_path)
    _add_cell(root)
    b = json.loads((root / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] in REFINE:
            m["workloads"].append("tiny_refine_b4")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    script = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
        "torch.set_num_threads(4)\n"
        "from deepim_tpu_torch.utils import profiling\n"
        "from portbench import run, trace\n"
        "trace.TRACE_FROM = 0.0\n"
        "out = []\n"
        "for keep in (True, False):\n"
        "    if not keep:\n"
        "        del profiling.spans\n"
        "    args = run.parse(['--workload', 'tiny_refine_b4', '--seed', '4294967311',"
        " '--seconds', '2', '--trace', '1'])\n"
        "    out.append(run.execute(args, torch.device('cpu')))\n"
        "print(json.dumps(out))\n")
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": ""}, cwd=root)
    assert done.returncode == 0, done.stderr[-3000:]
    with_spans, without = json.loads(done.stdout.strip().splitlines()[-1])
    metrics = with_spans["metrics"]
    assert metrics["refine.host_syncs_per_call"]["value"] == 0.0  # no CUDA: no sync
    assert 0.0 < metrics["refine.raster_front_idle_share"]["value"] < 100.0
    assert not set(REFINE) & set(without["metrics"])
    assert with_spans["correct"] and without["correct"]
    assert "tiny.poses_per_call" in without["metrics"]


def test_traced_tiny_train_cell_reports_its_span_metrics(monkeypatch):
    monkeypatch.setattr(trace, "TRACE_FROM", 0.0)  # the stretch opens with the first step
    clear_spans()  # one run a process, as run.py makes
    args = run.parse(["--workload", "synthetic_all_train_b32", "--seed", "4294967311",
                      "--seconds", "2", "--trace", "1"])
    torch.set_num_threads(4)
    res = run.execute(args, torch.device("cpu"), tiny("train"))
    metrics = {n: m["value"] for n, m in res["metrics"].items()}
    assert set(TRAIN) <= set(metrics)
    assert metrics["train.host_syncs_per_step"] == 0.0
    assert 0.0 < metrics["train.synthesis_idle_share"] < 100.0
    assert 0.0 < metrics["train.launch_idle_share"] < 100.0
    assert metrics["train.synthesis_idle_share"] + metrics["train.launch_idle_share"] <= 100.0


def test_spans_main_prints_the_idle_by_span_table(monkeypatch, capsys):
    """``python3 -m portbench.spans`` on the tiny training cell: run.execute's
    result line, with the stretch's idle seconds by innermost span adding up
    to its idle seconds."""
    monkeypatch.setattr(trace, "TRACE_FROM", 0.0)
    clear_spans()  # one run a process, as run.py makes
    torch.set_num_threads(4)
    assert spans.main(["--workload", "synthetic_all_train_b32", "--seed", "4294967311",
                       "--seconds", "2"], tiny("train")) == 0
    assert run.Tracer is trace.Tracer
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and set(TRAIN) <= set(out["metrics"])
    table = out["spans"]
    assert table["traced"] > 0 and table["traced_rate"] > 0 and table["count"] > 0
    assert {"train.step", "train.synthesis", "render.raster", spans.OUTSIDE} \
        <= set(table["idle_by_span"])
    idle = out["device"]["window_s"] - out["device"]["busy_s"]
    assert sum(table["idle_by_span"].values()) == pytest.approx(idle, rel=1e-6, abs=1e-9)
    assert set(table["syncs_by_span"].values()) == {0}
