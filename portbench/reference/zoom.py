"""The zoom: a crop window from the pose, its intrinsics, and the crop.

The window is centred on the projected object centre, holds the projected
AABB corners with a 1.4 margin (40 px at least) and has the output's
aspect ratio; the crop's intrinsics render straight into it; the observed
frame is resampled into it bilinearly (nearest for masks and depths) at
pixel centres, with zeros outside the frame.  Resampling is written as
two separable interpolation matrices, each output row and column a
weighted sum of source rows and columns.
"""

from __future__ import annotations

import torch

from portbench.reference.geometry import mv, transform


def project(points_cam, k):
    z = points_cam[..., 2:3].clamp_min(1e-8)
    return mv(k.unsqueeze(-3), points_cam / z)[..., :2]


def zoom_box(pose, k, corners, out_size, margin=1.4, min_px=40.0):
    """-> (x0, y0, sx, sy), each (B,)."""
    oh, ow = out_size
    uv = project(transform(corners, pose), k)
    origin = torch.zeros((pose.shape[0], 1, 3), device=pose.device)
    cu = project(transform(origin, pose), k)[:, 0]
    hw = torch.maximum(uv[..., 0].amax(-1) - cu[:, 0], cu[:, 0] - uv[..., 0].amin(-1))
    hh = torch.maximum(uv[..., 1].amax(-1) - cu[:, 1], cu[:, 1] - uv[..., 1].amin(-1))
    hw = (hw * margin).clamp_min(min_px * 0.5)
    hh = (hh * margin).clamp_min(min_px * 0.5)
    hw = torch.maximum(hw, hh * (ow / oh))
    hh = hw / (ow / oh)
    return cu[:, 0] - hw, cu[:, 1] - hh, ow / (2.0 * hw), oh / (2.0 * hh)


def crop_k(k, box):
    x0, y0, sx, sy = box
    z = torch.zeros_like(x0)
    return torch.stack([torch.stack([k[:, 0, 0] * sx, z, (k[:, 0, 2] - x0) * sx], -1),
                        torch.stack([z, k[:, 1, 1] * sy, (k[:, 1, 2] - y0) * sy], -1),
                        torch.stack([z, z, torch.ones_like(x0)], -1)], -2)


def crop(img, box, out_size, nearest=False):
    """(B, H, W, C) -> (B, oh, ow, C)."""
    x0, y0, sx, sy = box
    oh, ow = out_size
    h, w = img.shape[1:3]
    dev = img.device
    src_y = y0[:, None] + (torch.arange(oh, device=dev, dtype=torch.float32) + 0.5) / sy[:, None]
    src_x = x0[:, None] + (torch.arange(ow, device=dev, dtype=torch.float32) + 0.5) / sx[:, None]

    def weights(src, n):
        centres = torch.arange(n, device=dev, dtype=torch.float32)
        if nearest:
            return (torch.round(src - 0.5)[..., None] == centres).to(torch.float32)
        return (1.0 - (src[..., None] - (centres + 0.5)).abs()).clamp_min(0.0)

    rows = torch.einsum("boh,bhwc->bowc", weights(src_y, h), img)
    return torch.einsum("bpw,bowc->bopc", weights(src_x, w), rows)
