"""Visualization: flow colour wheel, render overlays, mask views (numpy).

Port of ``deepim_tpu/utils/viz.py``.  Every function returns a uint8 HWC
image; :func:`save_image` writes one as PNG through
:mod:`deepim_tpu_torch.data.png` (no PIL).
"""

from __future__ import annotations

import numpy as np


def flow_to_rgb(flow: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """Optical flow (H, W, 2) -> Middlebury-style colour-wheel uint8 image:
    hue encodes direction, saturation magnitude."""
    flow = np.asarray(flow, np.float32)
    mag = np.linalg.norm(flow, axis=-1)
    ang = np.arctan2(-flow[..., 1], -flow[..., 0]) / np.pi  # [-1, 1]
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    h = (ang + 1.0) / 2.0  # [0, 1]
    s = np.clip(mag / max_mag, 0, 1)
    v = np.ones_like(s)
    # hsv -> rgb
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def overlay_render(obs_rgb: np.ndarray, ren_rgb: np.ndarray,
                   ren_depth: np.ndarray, alpha: float = 0.6) -> np.ndarray:
    """The rendered object blended, green-tinted, over the observed frame."""
    obs = np.asarray(obs_rgb, np.float32)
    ren = np.asarray(ren_rgb, np.float32).copy()
    ren[..., 1] = np.clip(ren[..., 1] * 1.3 + 0.15, 0, 1)  # green tint
    fg = (np.asarray(ren_depth) > 0)[..., None]
    out = np.where(fg, (1 - alpha) * obs + alpha * ren, obs)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def mask_to_rgb(mask: np.ndarray) -> np.ndarray:
    m = (np.asarray(mask) > 0.5).astype(np.uint8) * 255
    return np.stack([m, m, m], -1)


def side_by_side(*images: np.ndarray, pad: int = 4) -> np.ndarray:
    """Horizontal montage of uint8 images (grey ones as RGB)."""
    images = [np.asarray(im) for im in images]
    h = max(im.shape[0] for im in images)
    cols = []
    for im in images:
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        canvas = np.zeros((h, im.shape[1] + pad, 3), np.uint8)
        canvas[: im.shape[0], : im.shape[1]] = im
        cols.append(canvas)
    return np.concatenate(cols, axis=1)


def save_image(path: str, image: np.ndarray) -> None:
    """Write a uint8 RGB (H, W, 3) or grey (H, W) image as PNG."""
    from deepim_tpu_torch.data.png import write_png  # data imports the raster, which imports utils

    write_png(path, np.asarray(image))
