"""6D pose error metrics: ADD, ADD-S, rotation/translation error, Proj-2D, AUC.

Port of ``deepim_tpu/geometry/pose_errors.py``.  Every function maps over
leading dims and computes in float32 on the device of its inputs; the
small products go through the broadcast-multiply-sum of
:mod:`~deepim_tpu_torch.geometry.se3`, so they stay true float32 whatever
the process's TF32 settings (the reference runs them at
``Precision.HIGHEST``).
"""

from __future__ import annotations

import math

import torch

from deepim_tpu_torch.geometry.rotations import rotation_angle
from deepim_tpu_torch.geometry.se3 import _mm, project_points, transform_points


def _posed(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    return transform_points(points, pose[..., :3], pose[..., 3])


def add_error(points: torch.Tensor, pose_est: torch.Tensor,
              pose_gt: torch.Tensor) -> torch.Tensor:
    """ADD: mean ‖(R̂x+t̂) − (Rx+t)‖₂ over model points (..., N, 3) -> (...)."""
    return torch.linalg.vector_norm(
        _posed(points, pose_est) - _posed(points, pose_gt), dim=-1).mean(-1)


def adds_error(points: torch.Tensor, pose_est: torch.Tensor, pose_gt: torch.Tensor,
               point_block: int | None = None) -> torch.Tensor:
    """ADD-S: mean over GT points of the distance to the nearest estimated
    point.

    Both point sets are centred on the GT centroid first: the
    ‖a‖²+‖b‖²−2a·b form loses float32 precision when the coordinates
    (camera z ≈ 1 m) dwarf the mm-scale distances it measures.
    ``point_block`` tiles the estimated points so the live distance matrix
    is (..., N, point_block), with a running min over the blocks; None
    keeps one full (..., N, N) matrix.  The cross term a·b is written as
    three products summed, x·x' + y·y' + z·z': a broadcast multiply-sum
    would hold a (..., N, 3, point_block) product, three times the
    distance matrix (4.7 GB a block at the evaluator's chunk of 256 and
    3,000 points).
    """
    p_est, p_gt = _posed(points, pose_est), _posed(points, pose_gt)
    center = p_gt.mean(-2, keepdim=True)
    p_est, p_gt = p_est - center, p_gt - center
    sq_gt = (p_gt * p_gt).sum(-1)  # (..., N)

    def min_d2_to(block):  # (..., blk, 3) -> (..., N)
        sq_blk = (block * block).sum(-1)
        a, b = p_gt[..., :, None, :], block[..., None, :, :]
        cross = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
        d2 = sq_gt[..., :, None] + sq_blk[..., None, :] - 2.0 * cross
        return d2.clamp_min(0.0).amin(-1)

    n_est = p_est.shape[-2]
    if point_block is None or point_block >= n_est:
        min_d2 = min_d2_to(p_est)
    else:
        min_d2 = torch.full_like(sq_gt, math.inf)
        for i0 in range(0, n_est, point_block):
            min_d2 = torch.minimum(min_d2, min_d2_to(p_est[..., i0:i0 + point_block, :]))
    return min_d2.sqrt().mean(-1)


def rot_error_deg(pose_est: torch.Tensor, pose_gt: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation error in degrees."""
    r_rel = _mm(pose_est[..., :3], pose_gt[..., :3].transpose(-1, -2))
    return torch.rad2deg(rotation_angle(r_rel))


def trans_error(pose_est: torch.Tensor, pose_gt: torch.Tensor) -> torch.Tensor:
    """Translation error ‖t̂ − t‖₂ (meters in LM6d convention)."""
    return torch.linalg.vector_norm(pose_est[..., 3] - pose_gt[..., 3], dim=-1)


def proj2d_error(points: torch.Tensor, pose_est: torch.Tensor, pose_gt: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
    """Mean 2D reprojection error (pixels) of model points."""
    uv_est = project_points(_posed(points, pose_est), k)
    uv_gt = project_points(_posed(points, pose_gt), k)
    return torch.linalg.vector_norm(uv_est - uv_gt, dim=-1).mean(-1)


def add_auc(errors: torch.Tensor, max_threshold: float = 0.1,
            steps: int = 1000) -> torch.Tensor:
    """Area under the accuracy-vs-threshold curve (YCB-Video protocol):
    the mean over thresholds τ in (0, max_threshold] of the fraction of
    per-sample errors (..., N) below τ, in [0, 1]."""
    thresholds = torch.linspace(0.0, max_threshold, steps + 1,
                                device=errors.device)[1:]
    acc = (errors[..., None] < thresholds).to(torch.float32).mean(-2)
    return acc.mean(-1)
