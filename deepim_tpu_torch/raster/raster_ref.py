"""Brute-force rasterizer — the port's golden oracle renderer in tests.

Port of ``deepim_tpu/raster/raster_xla.py`` (``Lighting``,
``FLAT_LIGHTING``, ``project_vertices``, ``shade_vertices``,
``render_mesh`` with ``cull_dir``).  Every pixel tests every face in
chunks, keeps the nearest, then one deferred shading pass recomputes the
barycentrics of each pixel's winner.  Depth is metric camera z, 0 marks
background; pixel centers sit at integer + 0.5; faces with any vertex
behind ``z_near`` are rejected whole.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepim_tpu_torch.geometry.se3 import transform_points

_BIG = 1e9


class Lighting(NamedTuple):
    """Gouraud lighting: color = albedo * (ambient + diffuse * |n·l|).

    ``direction`` points from the surface toward the light, camera frame.
    """

    ambient: float
    diffuse: float
    direction: tuple[float, float, float]


FLAT_LIGHTING = Lighting(ambient=1.0, diffuse=0.0, direction=(0.0, 0.0, -1.0))


def light_direction(lighting: Lighting, like: torch.Tensor) -> torch.Tensor:
    """Unit light direction (3,) with ``like``'s dtype and device."""
    l = torch.tensor(lighting.direction, dtype=like.dtype, device=like.device)
    return l / torch.linalg.vector_norm(l).clamp_min(1e-8)


def shade_vertices(colors, normals, pose, lighting: Lighting):
    """Per-vertex two-sided Gouraud shading in camera frame. (V,3) -> (V,3)."""
    n_cam = transform_points(normals, pose[..., :3], torch.zeros_like(pose[..., 3]))
    ndotl = (n_cam * light_direction(lighting, normals)).sum(-1)
    ndotl = torch.maximum(ndotl.clamp_min(0.0), (-ndotl).clamp_min(0.0))
    intensity = lighting.ambient + lighting.diffuse * ndotl
    return torch.clamp(colors * intensity[..., None], 0.0, 1.0)


def project_vertices(vertices, pose, k):
    """Object-frame verts (V,3) -> screen xy (V,2) + camera z (V,)."""
    v_cam = transform_points(vertices, pose[..., :3], pose[..., 3])
    z = v_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-8, 1e-8, z)
    u = k[..., 0, 0, None] * v_cam[..., 0] / z_safe + k[..., 0, 2, None]
    v = k[..., 1, 1, None] * v_cam[..., 1] / z_safe + k[..., 1, 2, None]
    return torch.stack([u, v], dim=-1), z


def _edge(ax, ay, bx, by, cx, cy):
    """2D cross of (b - a) x (c - a)."""
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


@torch.no_grad()
def render_mesh(vertices, faces, colors, normals, pose, k,
                image_size: tuple[int, int],
                lighting: Lighting = FLAT_LIGHTING, z_near: float = 0.01,
                chunk: int = 64, cull_dir: float | None = None):
    """Render one mesh at one pose -> (rgb (H, W, 3), depth (H, W))."""
    h, w = image_size
    dev = vertices.device
    screen, z = project_vertices(vertices, pose, k)
    shaded = shade_vertices(colors, normals, pose, lighting)
    faces = faces.long()
    tri_xy = screen[faces]  # (F, 3, 2)
    tri_z = z[faces]  # (F, 3)
    face_ok = (tri_z > z_near).all(-1)
    if cull_dir is not None:
        d = ((tri_xy[:, 1, 1] - tri_xy[:, 2, 1])
             * (tri_xy[:, 0, 0] - tri_xy[:, 2, 0])
             + (tri_xy[:, 2, 0] - tri_xy[:, 1, 0])
             * (tri_xy[:, 0, 1] - tri_xy[:, 2, 1]))
        face_ok = face_ok & ((cull_dir == 0.0) | (d * cull_dir < 0.0))

    py, px = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    zbuf = torch.full((h, w), _BIG, device=dev)
    ibuf = torch.full((h, w), -1, dtype=torch.long, device=dev)
    for base in range(0, faces.shape[0], chunk):
        txy = tri_xy[base:base + chunk]
        tz = tri_z[base:base + chunk]
        ok = face_ok[base:base + chunk]
        x0, y0 = txy[:, 0, 0, None, None], txy[:, 0, 1, None, None]
        x1, y1 = txy[:, 1, 0, None, None], txy[:, 1, 1, None, None]
        x2, y2 = txy[:, 2, 0, None, None], txy[:, 2, 1, None, None]
        w0 = _edge(x1, y1, x2, y2, px, py)
        w1 = _edge(x2, y2, x0, y0, px, py)
        w2 = _edge(x0, y0, x1, y1, px, py)
        area = _edge(x0, y0, x1, y1, x2, y2)
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                  | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
        inside &= area.abs() > 1e-12
        inside &= ok[:, None, None]
        inv_area = torch.where(area.abs() > 1e-12, 1.0 / area, 0.0)
        inv_z = (w0 * inv_area / tz[:, 0, None, None]
                 + w1 * inv_area / tz[:, 1, None, None]
                 + w2 * inv_area / tz[:, 2, None, None])
        zc = torch.where(inside & (inv_z > 1e-9),
                         1.0 / inv_z.clamp_min(1e-9), _BIG)
        zmin, best = zc.min(dim=0)
        upd = zmin < zbuf
        zbuf = torch.where(upd, zmin, zbuf)
        ibuf = torch.where(upd, base + best, ibuf)

    # Deferred shading: recompute barycentrics for each pixel's winner only.
    hit = ibuf >= 0
    fi = ibuf.clamp_min(0)
    txy = tri_xy[fi]  # (h, w, 3, 2)
    tz = tri_z[fi]  # (h, w, 3)
    tcol = shaded[faces[fi]]  # (h, w, 3, 3)
    xs, ys = txy[..., 0], txy[..., 1]
    w0 = _edge(xs[..., 1], ys[..., 1], xs[..., 2], ys[..., 2], px, py)
    w1 = _edge(xs[..., 2], ys[..., 2], xs[..., 0], ys[..., 0], px, py)
    w2 = _edge(xs[..., 0], ys[..., 0], xs[..., 1], ys[..., 1], px, py)
    area = _edge(xs[..., 0], ys[..., 0], xs[..., 1], ys[..., 1],
                 xs[..., 2], ys[..., 2])
    inv_area = torch.where(area.abs() > 1e-12, 1.0 / area, 0.0)
    b = torch.stack([w0, w1, w2], -1) * inv_area[..., None]
    bz = b / tz.clamp_min(1e-9)
    inv_z = bz.sum(-1)
    wgt = bz / inv_z[..., None].clamp_min(1e-9)
    rgb = (wgt[..., None] * tcol).sum(-2)
    rgb = torch.where(hit[..., None], rgb, 0.0)
    depth = torch.where(hit, zbuf, 0.0)
    return rgb, depth
