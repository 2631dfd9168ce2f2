"""Pose sampling and SE(3) perturbation (torch).

Port of ``deepim_tpu/data/pairs.py`` (``sample_poses_in_frustum``,
``perturb_poses``), drawing from an explicit ``torch.Generator``, which
also fixes the device the poses are made on.  The two packages draw
different numbers from the same seed; tests that compare them make their
poses with numpy.
"""

from __future__ import annotations

import math

import torch

from deepim_tpu_torch.geometry.rotations import euler2mat, quat2mat, random_quat
from deepim_tpu_torch.geometry.se3 import _mm, se3_from_rt


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand((n,), generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def sample_poses_in_frustum(generator: torch.Generator, n: int, k: torch.Tensor,
                            image_size: tuple[int, int],
                            z_range: tuple[float, float] = (0.5, 1.5),
                            border_frac: float = 0.25) -> torch.Tensor:
    """Uniformly random poses visible in the camera -> (n, 3, 4).

    Rotation uniform over SO(3); the object centre projects inside the
    central (1 - 2*border_frac) of the image at a depth uniform in
    ``z_range``.
    """
    h, w = image_size
    r = quat2mat(random_quat(generator, (n,)))
    z = _uniform(generator, n, *z_range)
    u = _uniform(generator, n, border_frac * w, (1 - border_frac) * w)
    v = _uniform(generator, n, border_frac * h, (1 - border_frac) * h)
    k = k.to(generator.device)
    x = (u - k[0, 2]) / k[0, 0] * z
    y = (v - k[1, 2]) / k[1, 1] * z
    return se3_from_rt(r, torch.stack([x, y, z], dim=-1))


def perturb_poses(generator: torch.Generator, poses: torch.Tensor,
                  rot_std_deg: float = 15.0, rot_max_deg: float = 45.0,
                  trans_std: tuple[float, float, float] = (0.01, 0.01, 0.05),
                  trans_max: tuple[float, float, float] = (0.03, 0.03, 0.15)
                  ) -> torch.Tensor:
    """Noisy poses from ``poses`` (n, 3, 4) (the reference's pair noise).

    Per-axis gaussian euler angles clipped at ``rot_max_deg``, applied as
    ΔR·R about the object centre; per-axis gaussian translation noise
    clipped at ``trans_max``; z kept >= 0.1.
    """
    n, dev = poses.shape[0], poses.device
    rmax = math.radians(rot_max_deg)
    ang = torch.randn((n, 3), generator=generator, device=generator.device).to(dev)
    ang = (ang * math.radians(rot_std_deg)).clamp(-rmax, rmax)
    dr = euler2mat(ang[:, 0], ang[:, 1], ang[:, 2])
    std = torch.tensor(trans_std, device=dev)
    tmax = torch.tensor(trans_max, device=dev)
    dt = torch.randn((n, 3), generator=generator, device=generator.device).to(dev)
    dt = torch.maximum(torch.minimum(dt * std, tmax), -tmax)
    r = _mm(dr, poses[..., :3])
    t = poses[..., 3] + dt
    t = torch.cat([t[:, :2], t[:, 2:].clamp_min(0.1)], dim=-1)
    return se3_from_rt(r, t)
