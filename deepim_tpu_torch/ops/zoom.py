"""Dynamic zoom-in: crop window from the current pose, crop intrinsics, and
the observed-image crop (torch).

Port of ``deepim_tpu/ops/zoom.py`` (``ZoomBox``, ``model_corners``,
``compute_zoom_box``, ``zoom_intrinsics``, ``zoom_image_batch``).  The
reference maps the per-sample functions with ``vmap``; here they
broadcast over leading batch dims.  The rendered image is never resampled:
it is rendered straight into the crop through :func:`zoom_intrinsics`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepim_tpu_torch.geometry.se3 import project_points, transform_points
from deepim_tpu_torch.ops.resample import resample_affine
from deepim_tpu_torch.raster.camera import crop_intrinsics


class ZoomBox(NamedTuple):
    """Axis-aligned crop: source-image window + output scale factors."""

    x0: torch.Tensor  # left edge (px, source image)
    y0: torch.Tensor  # top edge
    sx: torch.Tensor  # out_px-per-src_px scale in x
    sy: torch.Tensor  # scale in y


def model_corners(extent_min, extent_max) -> torch.Tensor:
    """8 corners (8, 3) of the object AABB from per-axis min/max (3,)."""
    lo = torch.as_tensor(extent_min, dtype=torch.float32)
    hi = torch.as_tensor(extent_max, dtype=torch.float32)
    return torch.stack([
        torch.stack([x[0], y[1], z[2]])
        for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)
    ])


def compute_zoom_box(pose: torch.Tensor, k: torch.Tensor, corners: torch.Tensor,
                     out_size: tuple[int, int], margin: float = 1.4,
                     min_size_px: float = 40.0) -> ZoomBox:
    """Crop window from the projected 3D bbox at the current pose.

    ``pose`` (..., 3, 4), ``k`` (..., 3, 3), ``corners`` (..., 8, 3).  The
    window has the output aspect ratio and is centred on the projected
    object centre, so Δt's (vx, vy) stay interpretable.
    """
    oh, ow = out_size
    r, t = pose[..., :3], pose[..., 3]
    uv = project_points(transform_points(corners, r, t), k)
    origin = torch.zeros((1, 3), dtype=pose.dtype, device=pose.device)
    center_uv = project_points(transform_points(origin, r, t), k)[..., 0, :]
    umin = uv[..., 0].amin(-1)
    umax = uv[..., 0].amax(-1)
    vmin = uv[..., 1].amin(-1)
    vmax = uv[..., 1].amax(-1)
    hw = torch.maximum(umax - center_uv[..., 0], center_uv[..., 0] - umin)
    hh = torch.maximum(vmax - center_uv[..., 1], center_uv[..., 1] - vmin)
    hw = (hw * margin).clamp_min(min_size_px * 0.5)
    hh = (hh * margin).clamp_min(min_size_px * 0.5)
    aspect = ow / oh
    hw = torch.maximum(hw, hh * aspect)
    hh = hw / aspect
    return ZoomBox(x0=center_uv[..., 0] - hw, y0=center_uv[..., 1] - hh,
                   sx=ow / (2.0 * hw), sy=oh / (2.0 * hh))


def zoom_intrinsics(k: torch.Tensor, box: ZoomBox) -> torch.Tensor:
    """K' that renders directly into the crop (skips rendered-image zoom)."""
    return crop_intrinsics(k, box.x0, box.y0, box.sx, box.sy)


def zoom_image_batch(imgs: torch.Tensor, box: ZoomBox, out_size: tuple[int, int],
                     method: str = "bilinear") -> torch.Tensor:
    """Crop+resize (B, H, W, C) images with per-sample (B,) boxes
    -> (B, H_out, W_out, C), filling outside the image with 0."""
    return resample_affine(imgs, out_size, box.x0, box.y0, box.sx, box.sy,
                           method=method)
