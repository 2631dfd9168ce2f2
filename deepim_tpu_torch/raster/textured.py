"""Per-pixel texture sampling on top of the raster kernels (torch).

Port of ``deepim_tpu/raster/textured.py``: a deferred pass that reuses the
raster kernels unchanged.  The three colour planes carry ``(u, v,
intensity)`` instead of RGB (perspective-correct, like any colour), and
the texture lookup runs afterwards as a bilinear gather over the rendered
UV image: ``tri_uv_corner_major``, ``pack_tri_params_uv``,
``sample_texture_bilinear``, ``sample_texture_atlas``,
``_map_batch_chunks`` and ``render_batch_textured``.

Texel convention, as in ``mesh.bake_texture_to_vertices``: x = u*(W-1),
y = (1-v)*(H-1) (image row 0 is v = 1), both clamped to [0, 1] first.
"""

from __future__ import annotations

import numpy as np
import torch

from deepim_tpu_torch.raster.raster_cuda import (
    SORT_TILE,
    _render_dispatch,
    check_tile,
    pack_corner_major,
)
from deepim_tpu_torch.raster.raster_ref import FLAT_LIGHTING, Lighting
from deepim_tpu_torch.utils.profiling import stage


def tri_uv_corner_major(mesh) -> np.ndarray:
    """Corner-major UVs of a textured mesh: (6, F), row 2*corner+coord."""
    if mesh.uv is None:
        raise ValueError("mesh has no UVs (not a textured PLY)")
    return mesh.uv[mesh.faces].reshape(-1, 6).T.copy()


def pack_tri_params_uv(tri_pos, tri_uv, tri_nrm, pose, k, lighting: Lighting,
                       z_near: float, cull_dir=None):
    """Like ``pack_tri_params``, but the colour planes carry (u, v, intensity).

    ``tri_pos``/``tri_nrm`` (B, 9, F); ``tri_uv`` (B, 6, F).  The
    projection and lighting math is the shared ``pack_corner_major``, so
    both packs agree in geometry and z-merge together.
    """
    return pack_corner_major(
        tri_pos, tri_nrm, pose, k, lighting, z_near,
        lambda c, intensity: (tri_uv[:, 2 * c], tri_uv[:, 2 * c + 1], intensity),
        cull_dir,
    )


def _bilinear(flat, base, h: int, w: int, u, v):
    """Bilinear taps of (h, w) images stacked in ``flat`` (N*h*w, 3), image
    offset ``base`` (flat index, broadcast against ``u``) -> (..., 3)."""
    x = u.clamp(0.0, 1.0) * (w - 1)
    y = (1.0 - v.clamp(0.0, 1.0)) * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)

    def tap(yy, xx):
        return flat[base + yy * w + xx]

    top = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
    bot = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def sample_texture_bilinear(texture, u, v):
    """Bilinear taps of one texture (Th, Tw, C) at (u, v) in [0, 1] -> (..., C)."""
    h, w = texture.shape[0], texture.shape[1]
    return _bilinear(texture.reshape(h * w, -1), 0, h, w, u, v)


def sample_texture_atlas(textures, tex_idx, u, v):
    """Per-sample bilinear taps into a class atlas (C, Th, Tw, 3).

    ``tex_idx`` (B,) selects each sample's texture by flat-index offset, so
    no (B, Th, Tw, 3) gathered copy is made; ``u``/``v`` are (B, ...).
    """
    c, h, w = textures.shape[0], textures.shape[1], textures.shape[2]
    base = tex_idx.long().reshape((-1,) + (1,) * (u.dim() - 1)) * (h * w)
    return _bilinear(textures.reshape(c * h * w, -1), base, h, w, u, v)


def _map_batch_chunks(fn, chunk: int, *args):
    """Apply ``fn`` over the shared leading (batch) axis in serial chunks.

    Bounds the deferred pass's live memory to one chunk's temporaries.  A
    batch that does not divide is zero-padded to the next multiple of
    ``chunk`` and sliced back (taps at u = v = 0 on pad rows are harmless);
    the result equals ``fn(*args)``.  ``chunk <= 0`` disables.
    """
    b = args[0].shape[0]
    if chunk <= 0 or b <= chunk:
        return fn(*args)
    pad = (-b) % chunk
    padded = [torch.cat([a, a.new_zeros((pad, *a.shape[1:]))]) if pad else a for a in args]
    outs = [fn(*(a[i:i + chunk] for a in padded)) for i in range(0, b + pad, chunk)]
    return torch.cat(outs)[:b]


@torch.no_grad()
def render_batch_textured(tri_pos, tri_uv, tri_nrm, poses, ks,
                          image_size: tuple[int, int], texture,
                          lighting: Lighting = FLAT_LIGHTING, z_near: float = 0.01,
                          binning: str = "auto", tex_idx=None,
                          max_faces_per_tile: int = 512,
                          spans: tuple[int, int] = (4, 2), cull_dir=None,
                          deferred_chunk: int = 16,
                          tile: tuple[int, int] = SORT_TILE):
    """Textured render -> (rgb (B, H, W, 3), depth (B, H, W)).

    ``texture`` is (Th, Tw, 3) shared, (B, Th, Tw, 3) per sample, or a
    (C, Th, Tw, 3) atlas indexed by ``tex_idx`` (B,).  The raster pass
    interpolates (u, v, intensity); the deferred pass samples the texture
    bilinearly in batch chunks of ``deferred_chunk`` (0 = unchunked) and
    multiplies by the intensity.  Background (depth 0) stays 0.
    ``binning``/``spans``/``max_faces_per_tile``/``cull_dir`` tune the
    raster dispatch as in ``render_batch_tri``.
    """
    check_tile(tile)
    with stage("render"):
        with stage("render.pack"):
            params, bbox, face_ok = pack_tri_params_uv(tri_pos, tri_uv, tri_nrm, poses, ks,
                                                       lighting, z_near, cull_dir)
        uvi, depth = _render_dispatch(params, bbox, face_ok, image_size, binning, spans,
                                      max_faces_per_tile)
        u, v, intensity = uvi.unbind(-1)
        if texture.dim() == 4 and tex_idx is not None:
            albedo = _map_batch_chunks(
                lambda uu, vv, ti: sample_texture_atlas(texture, ti, uu, vv),
                deferred_chunk, u, v, tex_idx)
        elif texture.dim() == 4:
            albedo = _map_batch_chunks(
                lambda tt, uu, vv: sample_texture_atlas(
                    tt, torch.arange(tt.shape[0], device=tt.device), uu, vv),
                deferred_chunk, texture, u, v)
        else:
            albedo = _map_batch_chunks(
                lambda uu, vv: sample_texture_bilinear(texture, uu, vv), deferred_chunk, u, v)
        rgb = (albedo * intensity[..., None]).clamp(0.0, 1.0)
        rgb = torch.where((depth > 0)[..., None], rgb, 0.0)
    return rgb, depth
