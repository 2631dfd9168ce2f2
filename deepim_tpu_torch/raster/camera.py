"""Pinhole camera intrinsics helpers (OpenCV convention, pixel-center 0.5).

Port of ``deepim_tpu/raster/camera.py`` (``make_intrinsics``,
``crop_intrinsics``).
"""

from __future__ import annotations

import torch


def make_intrinsics(fx, fy, cx, cy, device: torch.device | str = "cpu") -> torch.Tensor:
    """Build a float32 3x3 K from scalars on ``device``."""
    return torch.tensor(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def crop_intrinsics(k: torch.Tensor, x0, y0, scale_x, scale_y) -> torch.Tensor:
    """K for rendering directly into a crop: pixel (u, v) in the crop
    corresponds to ((u/scale_x)+x0, (v/scale_y)+y0) in the original image.
    """
    fx, fy = k[..., 0, 0], k[..., 1, 1]
    cx, cy = k[..., 0, 2], k[..., 1, 2]
    zero = torch.zeros_like(fx)
    row0 = torch.stack([fx * scale_x, zero, (cx - x0) * scale_x], dim=-1)
    row1 = torch.stack([zero, fy * scale_y, (cy - y0) * scale_y], dim=-1)
    row2 = torch.stack([zero, zero, torch.ones_like(fx)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
