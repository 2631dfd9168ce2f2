"""Logging: a print that also appends to a log file, and a JSONL metrics
stream.  Port of ``deepim_tpu/utils/logging.py``."""

from __future__ import annotations

import json
import os
import sys
import time


class PrintAndLog:
    """print() that tees to a log file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path

    def __call__(self, *args, **kwargs):
        msg = " ".join(str(a) for a in args)
        print(msg, **{k: v for k, v in kwargs.items() if k != "file"})
        sys.stdout.flush()
        with open(self.path, "a") as f:
            f.write(msg + "\n")


class MetricsLogger:
    """Append-only JSONL scalar stream (one dict a step)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path

    def write(self, step: int, metrics: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def mkdir_if_missing(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
