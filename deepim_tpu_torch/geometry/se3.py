"""Rigid-transform (SE(3)) helpers on 3x4 pose matrices.

Port of ``deepim_tpu/geometry/se3.py`` (``_mm``, ``se3_from_rt``,
``se3_mul``, ``se3_inverse``, ``transform_points``, ``project_points``).  The reference runs these tiny
products at ``Precision.HIGHEST``; here they are broadcast-multiply + sum,
so they stay true float32 whatever the TF32 settings of the process are.
"""

from __future__ import annotations

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, k) @ (..., k, m) in true float32 (no TF32 path exists)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _mv(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, k) @ (..., k) -> (..., n) in true float32."""
    return (r * v.unsqueeze(-2)).sum(-1)


def se3_from_rt(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (R (...,3,3), t (...,3)) into a (..., 3, 4) pose matrix."""
    return torch.cat([r, t[..., None]], dim=-1)


def se3_mul(rt1: torch.Tensor, rt2: torch.Tensor) -> torch.Tensor:
    """Compose pose matrices: the result maps X through ``rt2`` then ``rt1``.

    (..., 3, 4) x (..., 3, 4) -> (..., 3, 4): ``R = R1 R2``, ``t = R1 t2 + t1``.
    """
    r1, t1 = rt1[..., :3], rt1[..., 3]
    return se3_from_rt(_mm(r1, rt2[..., :3]), _mv(r1, rt2[..., 3]) + t1)


def se3_inverse(rt: torch.Tensor) -> torch.Tensor:
    """Inverse pose: (..., 3, 4) -> (..., 3, 4)."""
    r_inv = rt[..., :3].transpose(-1, -2)
    return se3_from_rt(r_inv, -_mv(r_inv, rt[..., 3]))


def transform_points(points: torch.Tensor, r: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """Apply X -> R X + t to points (..., N, 3); R (..., 3, 3), t (..., 3)."""
    return _mv(r.unsqueeze(-3), points) + t[..., None, :]


def project_points(points_cam: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Pinhole-project camera-frame points (..., N, 3) with K (..., 3, 3).

    Returns pixel coords (..., N, 2) as (u, v).
    """
    z = points_cam[..., 2:3].clamp_min(1e-8)
    uvw = _mv(k.unsqueeze(-3), points_cam / z)
    return uvw[..., :2]
