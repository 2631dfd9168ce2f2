"""Axis-aligned affine crop+resize as two separable matmuls (torch).

Port of ``deepim_tpu/ops/resample.py`` (``bilinear_sample``,
``nearest_sample``, ``_bilinear_matrix``, ``_nearest_matrix``,
``resample_affine``, ``affine_grid``).  The reference chose the
separable-matmul form because gathers are slow on its hardware; the port
keeps it so the two agree by construction (a gather-based form is later
performance work).  Pixel centres sit at integer + 0.5 and out-of-bounds
taps are zero.  The products are float32 matmuls: they stay true f32 as
long as ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
default).
"""

from __future__ import annotations

import torch


def _taps(img: torch.Tensor, coords: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
          fill_value: float) -> torch.Tensor:
    """``img`` (*batch, H, W, C) at integer-valued float indices ``xi``,
    ``yi`` (*batch, *points) -> (*batch, *points, C); ``fill_value`` where
    an index is outside the image."""
    h, w, c = img.shape[-3:]
    batch = img.shape[:-3]
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
    flat_img = img.reshape(-1, h * w, c)
    flat_idx = idx.reshape(flat_img.shape[0], -1)
    v = torch.gather(flat_img, 1, flat_idx[..., None].expand(-1, -1, c))
    v = v.reshape(*batch, *coords.shape[len(batch):-1], c)
    return torch.where(inb[..., None], v, torch.as_tensor(fill_value, dtype=img.dtype,
                                                           device=img.device))


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    fill_value: float = 0.0) -> torch.Tensor:
    """Bilinear lookup of ``img`` (*batch, H, W, C) at ``coords``
    (*batch, *points, 2) as (x, y) with pixel centres at integer + 0.5
    -> (*batch, *points, C).  Each of the four taps outside the image
    reads ``fill_value``; the lerps run along x, then y, as the
    reference's."""
    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    v00 = _taps(img, coords, x0, y0, fill_value)
    v01 = _taps(img, coords, x0 + 1, y0, fill_value)
    v10 = _taps(img, coords, x0, y0 + 1, fill_value)
    v11 = _taps(img, coords, x0 + 1, y0 + 1, fill_value)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty


def nearest_sample(img: torch.Tensor, coords: torch.Tensor,
                   fill_value: float = 0.0) -> torch.Tensor:
    """Nearest-neighbour lookup of ``img`` (*batch, H, W, C) at ``coords``
    (*batch, *points, 2) as (x, y) with pixel centres at integer + 0.5
    -> (*batch, *points, C); ``fill_value`` outside the image.

    The index rounds half to even (``torch.round``, like ``jnp.round``) and
    the in-bounds test is made on the rounded index, as the reference's.
    The reference samples one image; the leading batch dims here replace
    its ``vmap``.
    """
    xi = torch.round(coords[..., 0] - 0.5)
    yi = torch.round(coords[..., 1] - 0.5)
    return _taps(img, coords, xi, yi, fill_value)


def _bilinear_matrix(src: torch.Tensor, size_in: int) -> torch.Tensor:
    """Interp matrix (..., out, in): bilinear weight of input pixel j for the
    output sample at source coordinate ``src[..., i]``.  Out-of-bounds
    samples get all-zero rows (fill 0)."""
    centers = torch.arange(size_in, dtype=torch.float32, device=src.device) + 0.5
    d = src[..., :, None] - centers
    return (1.0 - d.abs()).clamp_min(0.0)


def _nearest_matrix(src: torch.Tensor, size_in: int) -> torch.Tensor:
    """One-hot nearest-neighbour matrix (..., out, in); round half to even
    like ``jnp.round``."""
    idx = torch.round(src - 0.5)
    j = torch.arange(size_in, dtype=torch.float32, device=src.device)
    return (idx[..., :, None] == j).to(torch.float32)


def resample_affine(img: torch.Tensor, out_size: tuple[int, int], x0, y0, sx, sy,
                    method: str = "bilinear") -> torch.Tensor:
    """Crop+resize ``img`` (..., H, W, C) -> (..., H_out, W_out, C).

    ``x0``/``y0``/``sx``/``sy`` have ``img``'s leading shape; output pixel
    (i, j) samples source position ``x = x0 + (j + 0.5) / sx``,
    ``y = y0 + (i + 0.5) / sy``.
    """
    if method not in ("bilinear", "nearest"):
        raise ValueError(method)
    oh, ow = out_size
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    src_y = y0[..., None] + (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / sy[..., None]
    src_x = x0[..., None] + (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / sx[..., None]
    make = _bilinear_matrix if method == "bilinear" else _nearest_matrix
    wy = make(src_y, h)  # (..., oh, h)
    wx = make(src_x, w)  # (..., ow, w)
    tmp = torch.einsum("...oh,...hwc->...owc", wy, img)
    return torch.einsum("...pw,...owc->...opc", wx, tmp)


def affine_grid(out_size: tuple[int, int], x0, y0, sx, sy) -> torch.Tensor:
    """Pixel-centre sample coordinates (H_out, W_out, 2) of an axis-aligned
    affine crop: output pixel (i, j) samples ``x = x0 + (j + 0.5) / sx``,
    ``y = y0 + (i + 0.5) / sy`` (scalar tensors), the inverse of the map of
    ``raster.camera.crop_intrinsics``."""
    oh, ow = out_size
    x0, y0, sx, sy = (torch.as_tensor(v, dtype=torch.float32) for v in (x0, y0, sx, sy))
    dev = x0.device
    jj = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / sx
    ii = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / sy
    xs = (x0 + jj[None, :]).expand(oh, ow)
    ys = (y0 + ii[:, None]).expand(oh, ow)
    return torch.stack([xs, ys], dim=-1)
