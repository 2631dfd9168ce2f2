"""Audit copies of protocol results (``deepim_tpu/utils/results.py``).

``output/`` is not committed, so protocol runs also write their KB-scale
result JSONs where they can be committed (``--results-out`` of
``cli.test`` and ``cli.track``), wrapped with what it takes to re-run the
measurement: the argv, the experiment and the git revision.

One difference from the reference, by design: the revision carries a
``-dirty`` suffix when the working tree has uncommitted changes (``git
status --porcelain`` is not empty), so a result never cites a revision
that lacks the code that produced it.  Outside a git checkout of this
repository the revision is empty.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def record_result(path: str, payload, experiment: str = "",
                  argv: list[str] | None = None) -> None:
    """Write ``payload`` (a JSON-serializable result) to ``path`` wrapped
    with run metadata; parent directories are created."""
    meta = {
        "experiment": experiment,
        "argv": list(sys.argv[1:] if argv is None else argv),
        "recorded_unix": int(time.time()),
        "git": _git_rev(),
        "results": payload,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    print(f"recorded results -> {path}")


def _git(*args: str) -> str:
    return subprocess.run(["git", *args], cwd=_ROOT, capture_output=True, text=True,
                          timeout=10, check=True).stdout.strip()


def _git_rev() -> str:
    """Short HEAD of the checkout holding this package, ``-dirty`` when its
    tree has changes; empty when the package is not in a git checkout of
    its own (a checkout further up would name another tree)."""
    try:
        if os.path.realpath(_git("rev-parse", "--show-toplevel")) != os.path.realpath(_ROOT):
            return ""
        rev = _git("rev-parse", "--short", "HEAD")
        return rev + "-dirty" if _git("status", "--porcelain") else rev
    except (OSError, subprocess.SubprocessError):
        return ""
