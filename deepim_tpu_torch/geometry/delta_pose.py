"""The DeepIM "untangled" delta-pose parameterization.

Port of ``deepim_tpu/geometry/delta_pose.py`` (``DeltaPose``,
``apply_delta``, ``calc_delta``).

- Rotation: ``R_tgt = ΔR @ R_src`` about the object center (translation
  unaffected by the rotation).
- Translation: ``vx = fx (x_t/z_t - x_s/z_s)``, ``vy`` likewise, and
  ``vz = log(z_s / z_t)``.

``calc_delta`` and ``apply_delta`` are exact inverses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepim_tpu_torch.geometry.rotations import mat2quat, quat2mat
from deepim_tpu_torch.geometry.se3 import _mm, se3_from_rt


class DeltaPose(NamedTuple):
    """Untangled relative pose: quat (..., 4) + image-relative trans (..., 3)."""

    quat: torch.Tensor  # (..., 4) (w, x, y, z), ΔR about object center
    trans: torch.Tensor  # (..., 3) (vx, vy, vz)


def calc_delta(pose_src: torch.Tensor, pose_tgt: torch.Tensor,
               k: torch.Tensor) -> DeltaPose:
    """Untangled delta taking ``pose_src`` to ``pose_tgt``; poses (..., 3, 4)."""
    r_src, t_src = pose_src[..., :3], pose_src[..., 3]
    r_tgt, t_tgt = pose_tgt[..., :3], pose_tgt[..., 3]
    quat = mat2quat(_mm(r_tgt, r_src.transpose(-1, -2)))

    fx = k[..., 0, 0]
    fy = k[..., 1, 1]
    zs = t_src[..., 2]
    zt = t_tgt[..., 2]
    vx = fx * (t_tgt[..., 0] / zt - t_src[..., 0] / zs)
    vy = fy * (t_tgt[..., 1] / zt - t_src[..., 1] / zs)
    vz = torch.log(zs / zt)
    return DeltaPose(quat=quat, trans=torch.stack([vx, vy, vz], dim=-1))


def apply_delta(pose_src: torch.Tensor, delta: DeltaPose,
                k: torch.Tensor) -> torch.Tensor:
    """Compose an untangled delta onto ``pose_src``; the refine-loop update."""
    r_src, t_src = pose_src[..., :3], pose_src[..., 3]
    r_tgt = _mm(quat2mat(delta.quat), r_src)

    fx = k[..., 0, 0]
    fy = k[..., 1, 1]
    vx, vy, vz = delta.trans.unbind(-1)
    zs = t_src[..., 2]
    zt = zs * torch.exp(-vz)
    xt = (vx / fx + t_src[..., 0] / zs) * zt
    yt = (vy / fy + t_src[..., 1] / zs) * zt
    return se3_from_rt(r_tgt, torch.stack([xt, yt, zt], dim=-1))
