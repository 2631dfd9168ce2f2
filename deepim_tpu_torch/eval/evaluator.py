"""Pose evaluation: ADD(-S) @ 0.1d, (5°, 5 cm), Proj-2D @ 5 px, AUC tables.

Port of ``deepim_tpu/eval/evaluator.py``: ``EvalThresholds``,
``PROPORTION_METRICS``, the Wilson intervals (``wilson_ci``,
``ci_halfwidth``, ``macro_mean_halfwidth``), ``compute_pose_errors``,
``evaluate_poses`` and ``format_table``.

The per-sample errors are computed in float32 on the device of the assets,
in fixed chunks; everything after them (thresholds, means, intervals, the
table) is the reference's numpy code, with the diameters as float32 numpy,
so two runs whose per-sample errors agree print the same table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deepim_tpu_torch.geometry.pose_errors import (
    add_auc, add_error, adds_error, proj2d_error, rot_error_deg, trans_error)
from deepim_tpu_torch.geometry.se3 import se3_mul
from deepim_tpu_torch.refine.refiner import RenderAssets


@dataclass(frozen=True)
class EvalThresholds:
    """The standard 6D-pose thresholds of the reference and the paper."""

    add_frac: float = 0.1  # ADD < 0.1 * diameter
    rot_deg: float = 5.0  # (5°, 5 cm)
    trans_m: float = 0.05
    proj_px: float = 5.0  # Proj-2D < 5 px
    auc_max_m: float = 0.1  # YCB AUC threshold range


PROPORTION_METRICS = ("add(-s)_0.1d", "add_0.1d", "adds_0.1d",
                      "5deg_5cm", "proj2d_5px")


def wilson_ci(p_pct: float, n: int, z: float = 1.96) -> tuple[float, float]:
    """95 % Wilson score interval of a success proportion, in percent.

    Every accuracy in the tables is a binomial proportion, so its sampling
    noise follows from (p, n) alone.  Wilson rather than the normal
    approximation: it behaves near 0 and 100 % and at small n (100 % at
    n=64 reads ±5.7, not ±0).
    """
    if n <= 0:
        return (float("nan"), float("nan"))
    p = min(max(p_pct / 100.0, 0.0), 1.0)
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    hw = (z * np.sqrt(p * (1 - p) / n + z2 / (4 * n * n))) / denom
    return (max(0.0, center - hw) * 100, min(1.0, center + hw) * 100)


def ci_halfwidth(p_pct: float, n: int, z: float = 1.96) -> float:
    """Largest distance of the Wilson interval from the estimate (pct pts)."""
    lo, hi = wilson_ci(p_pct, n, z)
    return float(max(p_pct - lo, hi - p_pct))


def macro_mean_halfwidth(rows: list[dict], key: str, z: float = 1.96) -> float:
    """95 % half-width of the macro (per-class) mean of a proportion.

    Classes are independent eval sets, so var(mean) = Σ p_i(1-p_i)/n_i / C²
    (normal approximation, fine at the aggregate n it is used for).
    """
    if not rows:
        return float("nan")
    var = 0.0
    for r in rows:
        p = min(max(r[key] / 100.0, 0.0), 1.0)
        n = max(int(r["n"]), 1)
        var += p * (1 - p) / n
    return float(z * np.sqrt(var) / len(rows) * 100)


@torch.no_grad()
def compute_pose_errors(points: torch.Tensor, sym_poses: torch.Tensor,
                        pose_est: torch.Tensor, pose_gt: torch.Tensor, k: torch.Tensor,
                        point_block: int | None = None) -> dict[str, torch.Tensor]:
    """Every per-sample error measure -> dict of (B,) tensors.

    ``points`` (B, N, 3) per-sample model points, ``sym_poses`` (B, S, 3,
    4) symmetry sets (identity-padded), ``pose_est``/``pose_gt`` (B, 3, 4),
    ``k`` (B, 3, 3).  ``add_sym`` is ADD against the nearest of the
    symmetry-equivalent GT poses (broadcast over S); ``adds`` is
    nearest-point ADD-S, its distance matrix tiled over ``point_block``
    estimated points (:func:`~deepim_tpu_torch.geometry.pose_errors.adds_error`).
    """
    gt_syms = se3_mul(pose_gt[:, None], sym_poses)  # (B, S, 3, 4)
    add_sym = add_error(points[:, None], pose_est[:, None], gt_syms).amin(1)
    return {
        "add": add_error(points, pose_est, pose_gt),
        "adds": adds_error(points, pose_est, pose_gt, point_block=point_block),
        "add_sym": add_sym,
        "rot_deg": rot_error_deg(pose_est, pose_gt),
        "trans_m": trans_error(pose_est, pose_gt),
        "proj2d_px": proj2d_error(points, pose_est, pose_gt, k),
    }


def evaluate_poses(assets: RenderAssets, class_names: list[str], symmetric: list[bool],
                   pose_est: np.ndarray, pose_gt: np.ndarray, class_idx: np.ndarray,
                   k: np.ndarray, thresholds: EvalThresholds = EvalThresholds(),
                   chunk: int = 256, point_block: int = 512) -> dict:
    """Per-class and mean metric table (the reference's ``evaluate_pose``).

    ``pose_est``/``pose_gt`` (B, 3, 4), ``class_idx`` (B,) and ``k`` (B, 3,
    3) are host arrays; the errors are computed on the assets' device in
    chunks of ``chunk`` rows (the last one padded by repeating its last
    row, the padding dropped), so an eval of 10k+ frames x 3,000 points
    runs in bounded memory.  Symmetric classes are scored with ADD-S (the
    reference protocol); the headline ADD(-S) row mixes the two.
    """
    dev = assets.points.device
    b = int(np.asarray(pose_est).shape[0])
    chunk = min(chunk, b)
    parts: list[dict[str, np.ndarray]] = []
    for i in range(0, b, chunk):
        sl = slice(i, min(i + chunk, b))
        size = sl.stop - sl.start
        pad = chunk - size

        def take(x):
            x = np.asarray(x)[sl]
            if pad:  # repeat the last row: one chunk shape
                x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        idx = take(class_idx).long()
        out = compute_pose_errors(
            assets.points.index_select(0, idx), assets.sym_poses.index_select(0, idx),
            take(pose_est).float(), take(pose_gt).float(), take(k).float(),
            point_block=point_block)
        parts.append({kk: v[:size].cpu().numpy() for kk, v in out.items()})
    errs = {kk: np.concatenate([p[kk] for p in parts]) for kk in parts[0]}
    diam = assets.diameters.cpu().numpy().astype(np.float32)

    per_class = {}
    all_rows = []
    for ci, name in enumerate(class_names):
        m = np.asarray(class_idx) == ci
        n = int(m.sum())
        if n == 0:
            continue
        add_like = errs["adds"][m] if symmetric[ci] else errs["add"][m]
        thresh = thresholds.add_frac * diam[ci]
        row = {
            "n": n,
            "add(-s)_0.1d": float((add_like < thresh).mean() * 100),
            "add_0.1d": float((errs["add"][m] < thresh).mean() * 100),
            "adds_0.1d": float((errs["adds"][m] < thresh).mean() * 100),
            "5deg_5cm": float(
                ((errs["rot_deg"][m] < thresholds.rot_deg)
                 & (errs["trans_m"][m] < thresholds.trans_m)).mean() * 100),
            "proj2d_5px": float((errs["proj2d_px"][m] < thresholds.proj_px).mean() * 100),
            "auc_add(-s)": float(add_auc(torch.from_numpy(add_like),
                                         thresholds.auc_max_m) * 100),
            "mean_add_m": float(add_like.mean()),
            "mean_rot_deg": float(errs["rot_deg"][m].mean()),
            "mean_trans_m": float(errs["trans_m"][m].mean()),
        }
        row["ci95"] = {kk: round(ci_halfwidth(row[kk], n), 2) for kk in PROPORTION_METRICS}
        per_class[name] = row
        all_rows.append(row)

    mean = {
        kk: float(np.mean([r[kk] for r in all_rows]))
        for kk in all_rows[0]
        if kk not in ("n", "ci95")
    } if all_rows else {}
    if mean:
        mean["ci95"] = {kk: round(macro_mean_halfwidth(all_rows, kk), 2)
                        for kk in PROPORTION_METRICS}
    return {"per_class": per_class, "mean": mean, "num_samples": int(len(class_idx))}


def format_table(results: dict, title: str = "Pose evaluation") -> str:
    """Plain-text table in the reference's eval-log style.

    Proportion columns print as value±hw (95 % Wilson half-width), so every
    delta can be read against its own noise.
    """
    cols = ["add(-s)_0.1d", "5deg_5cm", "proj2d_5px", "auc_add(-s)",
            "mean_rot_deg", "mean_trans_m"]

    def cell(row, c):
        hw = row.get("ci95", {}).get(c)
        if hw is not None and hw == hw:
            return f"{row[c]:.2f}±{hw:.2f}"
        return f"{row[c]:.2f}"

    lines = [title, "=" * len(title)]
    header = f"{'class':<16}" + "".join(f"{c:>14}" for c in cols) + f"{'n':>8}"
    lines.append(header)
    lines.append("-" * len(header))
    for name, row in results["per_class"].items():
        lines.append(f"{name:<16}" + "".join(f"{cell(row, c):>14}" for c in cols)
                     + f"{row['n']:>8d}")
    if results["mean"]:
        lines.append("-" * len(header))
        lines.append(f"{'MEAN':<16}" + "".join(f"{cell(results['mean'], c):>14}" for c in cols)
                     + f"{results['num_samples']:>8d}")
    return "\n".join(lines)
