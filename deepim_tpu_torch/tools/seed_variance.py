"""Aggregate seed-variance eval runs -> mean ± σ per metric.

    python -m deepim_tpu_torch.tools.seed_variance output/occlusion_small_seed3 \
        output/occlusion_small_seed4 output/occlusion_small_seed5

Reads each run's ``eval_results.json`` (written by ``cli.test``) and
prints the cross-seed mean, sample σ, and range for the headline
metrics — the training-side noise floor that protocol deltas must clear.
Port of ``tools/seed_variance.py``: the same arguments, table and
``--results-out`` record (through ``deepim_tpu_torch.utils.results``).
"""

from __future__ import annotations

import argparse
import json
import math
import os

METRICS = ("add(-s)_0.1d", "5deg_5cm", "proj2d_5px", "auc_add(-s)")


def aggregate(means: list[dict]) -> dict[str, dict[str, float]]:
    """Per-run metric means -> {"mean", "sigma" (sample), "range"} of each
    headline metric across the runs."""
    out = {}
    for label, fn in (
        ("mean", lambda v: sum(v) / len(v)),
        ("sigma", lambda v: math.sqrt(sum((x - sum(v) / len(v)) ** 2 for x in v)
                                      / (len(v) - 1))),
        ("range", lambda v: max(v) - min(v)),
    ):
        out[label] = {k: fn([m[k] for m in means]) for k in METRICS}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dirs", nargs="*", help="per-seed run output dirs")
    p.add_argument("--results-out", default="",
                   help="record the aggregate into this JSON (committed results/ tree)")
    args = p.parse_args(argv)
    dirs = args.dirs
    if len(dirs) < 2:
        print(__doc__)
        return 2
    rows = []
    for d in dirs:
        with open(os.path.join(d, "eval_results.json")) as f:
            res = json.load(f)
        rows.append((d, res["mean"], res.get("num_samples")))
    print(f"{'run':<36}" + "".join(f"{m:>14}" for m in METRICS) + f"{'n':>7}")
    for d, m, n in rows:
        print(f"{os.path.basename(d.rstrip('/')):<36}"
              + "".join(f"{m[k]:>14.2f}" for k in METRICS) + f"{n:>7}")
    print("-" * (36 + 14 * len(METRICS) + 7))
    agg = aggregate([m for _, m, _ in rows])
    for label, vals in agg.items():
        print(f"{label:<36}" + "".join(f"{vals[k]:>14.2f}" for k in METRICS))
    if args.results_out:
        from deepim_tpu_torch.utils.results import record_result

        record_result(args.results_out, {
            "runs": [{"dir": d, "mean": m, "n": n} for d, m, n in rows], **agg,
        }, experiment="seed_variance", argv=list(dirs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
