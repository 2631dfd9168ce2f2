"""Axis-aligned affine crop+resize as two separable matmuls (torch).

Port of ``deepim_tpu/ops/resample.py`` (``nearest_sample``,
``_bilinear_matrix``, ``_nearest_matrix``, ``resample_affine``).  The reference chose the
separable-matmul form because gathers are slow on its hardware; the port
keeps it so the two agree by construction (a gather-based form is later
performance work).  Pixel centres sit at integer + 0.5 and out-of-bounds
taps are zero.  The products are float32 matmuls: they stay true f32 as
long as ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
default).
"""

from __future__ import annotations

import torch


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
    h, w, c = img.shape[-3:]
    batch = img.shape[:-3]
    xi = torch.round(coords[..., 0] - 0.5)
    yi = torch.round(coords[..., 1] - 0.5)
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
    flat_img = img.reshape(-1, h * w, c)
    flat_idx = idx.reshape(flat_img.shape[0], -1)
    v = torch.gather(flat_img, 1, flat_idx[..., None].expand(-1, -1, c))
    v = v.reshape(*batch, *coords.shape[len(batch):-1], c)
    return torch.where(inb[..., None], v, torch.as_tensor(fill_value, dtype=img.dtype,
                                                           device=img.device))


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
