"""The harness is data: a cell, a configuration, a traffic mix and a metric
are files found by name, and ``BENCHMARK.json`` keeps the contract's
name and unit rules."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT, TINY_EXPERIMENT
from portbench import spec

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def bench():
    return spec.benchmark(ROOT)


def test_benchmark_json_is_valid():
    assert spec.validate(bench()) == []


def test_names_and_units():
    b = bench()
    names = [e["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for e in b[group]]
    names += [c["config"] for c in b["workloads"]] + [c["traffic"] for c in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert set(n) <= NAME_CHARS and 1 <= len(n) <= 64 and n[0] not in ".-", n
    for m in b["end_to_end"] + b["per_layer"]:
        assert 1 <= len(m["unit"]) <= 16 and set(m["unit"]) <= NAME_CHARS | {"/", "%"}, m
    assert len(set(e["name"] for e in b["end_to_end"] + b["per_layer"])) == \
        len(b["end_to_end"]) + len(b["per_layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = bench()
    for c in b["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(b, c["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.metrics_for(b, c["name"], True)
        assert layers and all(m["moves"] in e2e for m in layers)


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    return root


def _add_cell(root: Path) -> None:
    """A throwaway configuration, traffic mix, cell and per-layer metric, as files."""
    here = root / "portbench"
    conf = json.loads((here / "configs" / "synthetic_all_c2f.json").read_text())
    conf["name"] = "tiny_c2f"
    for section, values in TINY_EXPERIMENT.items():
        conf["experiment"].setdefault(section, {}).update(values)
    (here / "configs" / "tiny_c2f.json").write_text(json.dumps(conf))
    (here / "traffic" / "closed_b4.json").write_text(json.dumps(
        {"driver": "refine", "batch": 4, "pool_batches": 2, "check_rows_per_batch": 2}))
    (here / "workloads" / "tiny_refine_b4.json").write_text(json.dumps(
        {"config": "tiny_c2f", "traffic": "closed_b4", "chips": 1, "why": "a test's cell",
         "limits": {"pose_gap": 1e-2, "draw_gap": 0.0}, "compare": {"pose_off_at": 5e-4}}))
    (here / "metrics" / "tiny.poses_per_call.py").write_text(
        "def read(run):\n"
        "    c = run.counts\n"
        "    return c['poses'] / c['calls'] if c.get('calls') else None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_c2f", "source": "a test", "reduced": ["input_height"],
                         "file": "portbench/configs/tiny_c2f.json"})
    b["workloads"].append({"name": "tiny_refine_b4", "config": "tiny_c2f",
                           "traffic": "closed_b4", "chips": 1, "why": "a test's cell"})
    next(m for m in b["end_to_end"] if m["name"] == "poses_per_s")["workloads"].append(
        "tiny_refine_b4")
    b["per_layer"].append({"name": "tiny.poses_per_call", "unit": "poses", "better": "higher",
                           "source": "program_counter", "layer": "refine loop and network",
                           "moves": "poses_per_s", "workloads": ["tiny_refine_b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_new_files_are_found_and_validated_by_name(tmp_path):
    root = _copy(tmp_path)
    _add_cell(root)
    here = root / "portbench"
    b = spec.benchmark(root)
    assert spec.validate(b, here) == []
    assert spec.config("tiny_c2f", here)["name"] == "tiny_c2f"
    assert spec.traffic("closed_b4", here)["driver"] == "refine"
    assert spec.workload("tiny_refine_b4", here)["limits"]["pose_gap"] == 1e-2
    names = [m["name"] for m in spec.metrics_for(b, "tiny_refine_b4", True)]
    assert names == ["tiny.poses_per_call"]
    read = spec.reader("tiny.poses_per_call", here)
    assert read(type("Run", (), {"counts": {"poses": 8, "calls": 2}})) == 4.0


@pytest.mark.parametrize("breakage,message", [
    ("traffic", "no traffic/closed_b4.json"),
    ("metric", "no metrics/tiny.poses_per_call.py"),
    ("limits", "no workloads/tiny_refine_b4.json"),
    ("name", "bad name"),
])
def test_what_is_missing_is_named(tmp_path, breakage, message):
    root = _copy(tmp_path)
    _add_cell(root)
    here = root / "portbench"
    if breakage == "traffic":
        (here / "traffic" / "closed_b4.json").unlink()
    elif breakage == "metric":
        (here / "metrics" / "tiny.poses_per_call.py").unlink()
    elif breakage == "limits":
        (here / "workloads" / "tiny_refine_b4.json").unlink()
    else:
        b = json.loads((root / "BENCHMARK.json").read_text())
        b["per_layer"][-1]["name"] = "tiny poses"
        (root / "BENCHMARK.json").write_text(json.dumps(b))
    assert any(message in e for e in spec.validate(spec.benchmark(root), here))


def test_a_new_cell_runs_from_its_files_alone(tmp_path):
    """The copy with the new files drives a whole traced run of the new cell
    on the CPU (the look for a chip skipped) and reports the new metric."""
    root = _copy(tmp_path)
    _add_cell(root)
    script = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
        "torch.set_num_threads(4)\n"
        "from portbench import run\n"
        "args = run.parse(['--workload', 'tiny_refine_b4', '--seed', '4294967311',"
        " '--seconds', '1', '--trace', '1'])\n"
        "print(json.dumps(run.execute(args, torch.device('cpu'))))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ""}, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["tiny.poses_per_call"]["value"] == 4.0
    assert res["correct"] and set(res["checks"]) == {"pose_gap", "draw_gap"}
