"""Shared settings of the benchmark's own tests.

They import the program (``deepim_tpu_torch``) and the reference side by
side on the CPU, never JAX.  ``TINY`` shrinks a cell to what a test run
can hold: 48x64 crops, 60x80 frames (the LINEMOD camera scaled to them),
64 surface points, a few rows; the program computes in float32 there, as
the CPU's bfloat16 is slow.  A test that needs the card is marked
``card`` and decides inside itself whether there is one.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_EXPERIMENT = {
    "network": {"input_height": 48, "input_width": 64, "dtype": "float32"},
    "dataset": {"image_height": 60, "image_width": 80, "fx": 71.5, "fy": 71.7, "cx": 40.0,
                "cy": 30.0, "num_points": 64},
    "train": {"batch_size": 4},
    "test": {"batch_size": 8},
}
TINY_TRAFFIC = {
    "refine": {"batch": 4, "pool_batches": 2, "check_rows_per_batch": 2},
    "serve": {"pool_rows": 16, "pool_batch": 8, "check_rows": 6, "rate_per_s": 4.0,
              "grace_s": 600, "clients": 8},
    "train": {},
}


def tiny(kind: str, **experiment) -> dict:
    """Overrides that shrink a cell whose driver is ``kind``."""
    exp = {k: dict(v) for k, v in TINY_EXPERIMENT.items()}
    for section, values in experiment.items():
        exp.setdefault(section, {}).update(values)
    return {"config": {"experiment": exp}, "traffic": dict(TINY_TRAFFIC[kind])}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")
