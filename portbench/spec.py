"""``BENCHMARK.json`` and the files it names, found by name.

The benchmark is data.  A cell (``BENCHMARK.json §workloads``) names a
configuration and a traffic mix; each lives in a file of its own:

- ``configs/<config>.json``: the experiment as the program loads it (the
  YAML's sections), the weights' seed rule, ``source``, ``reduced``,
  ``assumed``;
- ``traffic/<traffic>.json``: the driver that offers it (``drivers/<driver>.py``)
  and its parameters;
- ``workloads/<cell>.json``: the cell again (configuration, traffic, chips,
  why) and the limits its correctness numbers are held to;
- ``metrics/<metric>.py``: one reader a metric, ``read(run) -> float | None``.

A new cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``; nothing here changes.  :func:`validate`
refuses what the harness could not run.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return _json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{name}.json")


def workload(name: str, here: Path = HERE) -> dict:
    return _json(here / "workloads" / f"{name}.json")


def cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(name: str, here: Path = HERE):
    """The ``read`` of ``metrics/<name>.py`` (a name may hold dots)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with ``workloads``
    only in those cells."""
    pool = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in pool if "workloads" not in m or cell_name in m["workloads"]]


def validate(bench: dict, here: Path = HERE) -> list[str]:
    """What is wrong with ``bench`` and the files it names; [] when nothing."""
    errs = []
    if set(bench) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(bench)} != {sorted(TOP_KEYS)}")
    names = set()
    for group, keys in (("configs", CONFIG_KEYS), ("workloads", CELL_KEYS),
                        ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        for entry in bench.get(group, []):
            name = entry.get("name", "")
            if not NAME.match(name):
                errs.append(f"{group}: bad name {name!r}")
            if (group, name) in names or (group in ("end_to_end", "per_layer")
                                          and ("metric", name) in names):
                errs.append(f"{group}: {name!r} twice")
            names.add(("metric", name) if group in ("end_to_end", "per_layer") else (group, name))
            extra = set(entry) - keys
            if extra:
                errs.append(f"{group} {name}: unknown keys {sorted(extra)}")
            if "unit" in entry and not UNIT.match(entry["unit"]):
                errs.append(f"{group} {name}: bad unit {entry['unit']!r}")
            if "better" in entry and entry["better"] not in ("lower", "higher"):
                errs.append(f"{group} {name}: better must be lower or higher")
    e2e = {m["name"] for m in bench.get("end_to_end", [])}
    cells = {c["name"]: c for c in bench.get("workloads", [])}
    configs = {c["name"] for c in bench.get("configs", [])}
    for c in bench.get("configs", []):
        for key in c.get("reduced", []):
            if not NAME.match(key):
                errs.append(f"config {c['name']}: bad reduced key {key!r}")
        if not (here.parent / c.get("file", "")).is_file():
            errs.append(f"config {c['name']}: no file {c.get('file')!r}")
        if not (here / "configs" / f"{c['name']}.json").is_file():
            errs.append(f"config {c['name']}: no configs/{c['name']}.json")
    for name, c in cells.items():
        if c.get("config") not in configs:
            errs.append(f"cell {name}: unknown config {c.get('config')!r}")
        if not NAME.match(str(c.get("traffic", ""))):
            errs.append(f"cell {name}: bad traffic name")
        if not (here / "traffic" / f"{c.get('traffic')}.json").is_file():
            errs.append(f"cell {name}: no traffic/{c.get('traffic')}.json")
        wpath = here / "workloads" / f"{name}.json"
        if not wpath.is_file():
            errs.append(f"cell {name}: no workloads/{name}.json")
        else:
            w = _json(wpath)
            for key in ("config", "traffic", "chips"):
                if w.get(key) != c.get(key):
                    errs.append(f"cell {name}: workloads/{name}.json {key} != BENCHMARK.json's")
            if not w.get("limits"):
                errs.append(f"cell {name}: no limits")
        traffic_file = here / "traffic" / f"{c.get('traffic')}.json"
        if traffic_file.is_file():
            kind = _json(traffic_file).get("driver", "")
            if not (here / "drivers" / f"{kind}.py").is_file():
                errs.append(f"cell {name}: no drivers/{kind}.py")
        if c.get("chips") not in (1, 4):
            errs.append(f"cell {name}: chips must be 1 or 4")
    for group in ("end_to_end", "per_layer"):
        for m in bench.get(group, []):
            if not (here / "metrics" / f"{m['name']}.py").is_file():
                errs.append(f"metric {m['name']}: no metrics/{m['name']}.py")
            for w in m.get("workloads", []):
                if w not in cells:
                    errs.append(f"metric {m['name']}: unknown cell {w!r}")
            if group == "per_layer" and m.get("moves") not in e2e:
                errs.append(f"metric {m['name']}: moves {m.get('moves')!r}, "
                            "no such end-to-end metric")
    for name in cells:
        reported = {m["name"] for m in metrics_for(bench, name, False)}
        if "setup_s" not in reported or len(reported) < 2:
            errs.append(f"cell {name}: reports setup_s and at least one other end-to-end metric")
        if not metrics_for(bench, name, True):
            errs.append(f"cell {name}: no per-layer metric")
        for m in metrics_for(bench, name, True):
            if m.get("moves") not in reported:
                errs.append(f"cell {name}: {m['name']} moves {m.get('moves')}, "
                            "which it does not report")
    return errs
