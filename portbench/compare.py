"""The numbers that decide ``correct``, each held to a limit of its own.

- ``pose_off_share``: for every compared pose, the mean distance of the
  object's surface sample under the program's pose and under the
  reference's (ADD between the two), over the object's diameter; the
  share of compared poses, in percent, whose gap exceeds the cell's
  ``pose_off_at``.  It catches a precision lost everywhere (the control),
  but lets a few wrong poses through.
- ``pose_gap``: the largest of those gaps, held to a limit for gross
  errors: a wrong pose in a few slots or one class, which the share
  misses.  (The median gap is printed among the readings: it moves with
  the seed's network by a factor 2.)
- ``draw_gap``: the largest difference between a source pose the program
  refined and the one the reference draws from the same seed (0 when
  both take the same draws).
- ``loss_gap``: the largest relative difference of a training step's loss.
- ``grad_gap``, ``change_gap`` (and their ``_median``): for each parameter
  tensor (a leaf), the gap between the program's norm and the
  reference's, of the first clipped gradient and of the change the first
  three steps made, over the larger of the reference leaf's norm and the
  median leaf's; the worst leaf (and the median leaf's gap).  Leaves whose
  reference gradient is under a thousandth of the median leaf's move by
  round-off alone and are left out of the change.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import torch

from portbench.reference.geometry import transform

#: Reference gradients under this share of the median leaf's are rounding.
ROUNDING_LEAF = 1e-3


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def pose_gaps(points, diameters, poses_a, poses_b) -> torch.Tensor:
    """ADD(a, b) / diameter per row; ``points`` (B, N, 3)."""
    d = torch.linalg.vector_norm(transform(points, poses_a) - transform(points, poses_b), dim=-1)
    return d.mean(-1) / diameters


def gap_checks(state: dict, gaps: torch.Tensor, others: dict, limits: dict,
               off_at: float) -> list:
    """The pose-gap numbers of the compared poses and ``others``, each held
    to its limit in ``limits``; the gaps' quantiles go to the readings."""
    gaps = torch.nan_to_num(gaps.float(), nan=1e30).cpu()
    q = torch.quantile(gaps, torch.tensor([0.5, 0.9, 1.0])).tolist()
    share = 100.0 * float((gaps > off_at).float().mean())
    state["readings"] = {"poses_compared": len(gaps), "pose_gap_p50_p90_max": q}
    values = {"pose_off_share": share, "pose_gap": q[2], "pose_gap_median": q[0], **others}
    return [Check(n, values[n], limit) for n, limit in limits.items()]


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |prog - ref| / max(ref, median ref) of per-leaf norms."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(torch.tensor([ref[n] for n in names]).median())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def worst_and_median(gaps: dict) -> tuple[float, float, str]:
    worst = max(gaps, key=gaps.get)
    return gaps[worst], float(torch.tensor(list(gaps.values())).median()), worst


def moving_leaves(grad_norms: dict) -> set:
    med = float(torch.tensor(list(grad_norms.values())).median())
    return {n for n, v in grad_norms.items() if v >= ROUNDING_LEAF * med}


def report(checks: list[Check]) -> dict:
    """Print each number beside its limit as the last lines on stderr and
    return them for the result line."""
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr, flush=True)
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}
