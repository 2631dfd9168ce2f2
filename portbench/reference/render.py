"""A brute-force rasterizer (plain PyTorch, float32).

What it computes is what the renderer under test states it computes: each
corner is moved into the camera, projected through ``k`` and lit with
two-sided Gouraud shading (``albedo * (ambient + diffuse * |n . l|)``,
clipped to [0, 1]); a face is dropped when a corner lies within ``z_near``
of the camera, when its projected area is zero, or when the mesh is
closed and the face turns away (``cull``).  Every pixel centre (x + 0.5,
y + 0.5) is tested against every face: inside when its three barycentric
planes are all >= 0, and the nearest (the largest perspective-correct
inverse depth, the first face on a tie) wins.  Depth is metric z (0 on the
background); colour is the perspective-correct interpolation.

No binning, no tiles, no kernel: each sample loops over its mesh's faces
in chunks, over the box that holds the faces it keeps.
"""

from __future__ import annotations

import torch

Z_NEAR = 0.01
FACE_CHUNK = 64


def _corners(tri_pos, tri_col, tri_nrm, pose, k, light):
    """-> screen x, y (3, F), camera z (3, F), shaded colour (3, 3, F)."""
    r, t = pose[:, :3], pose[:, 3]
    p = tri_pos.reshape(3, 3, -1)  # corner, coord, face
    n = tri_nrm.reshape(3, 3, -1)
    c = tri_col.reshape(3, 3, -1)
    cam = (r[None, :, :, None] * p[:, None, :, :]).sum(2) + t[None, :, None]
    z = cam[:, 2]
    z_safe = torch.where(z.abs() < 1e-8, 1e-8, z)
    x = k[0, 0] * cam[:, 0] / z_safe + k[0, 2]
    y = k[1, 1] * cam[:, 1] / z_safe + k[1, 2]
    ambient, diffuse, direction = light
    d = torch.as_tensor(direction, dtype=torch.float32, device=p.device)
    d = d / torch.linalg.vector_norm(d).clamp_min(1e-8)
    n_cam = (r[None, :, :, None] * n[:, None, :, :]).sum(2)
    ndotl = (n_cam * d[None, :, None]).sum(1)
    col = (c * (ambient + diffuse * ndotl.abs())[:, None, :]).clamp(0.0, 1.0)
    return x, y, z, col


def render_one(tri_pos, tri_col, tri_nrm, cull, pose, k, size, light):
    """One mesh at one pose -> rgb (H, W, 3), depth (H, W)."""
    h, w = size
    dev = tri_pos.device
    x, y, z, col = _corners(tri_pos, tri_col, tri_nrm, pose, k, light)
    d = (y[1] - y[2]) * (x[0] - x[2]) + (x[2] - x[1]) * (y[0] - y[2])
    keep = (z > Z_NEAR).all(0) & (d.abs() > 1e-12) & ((cull == 0) | (d * cull < 0))
    rgb = torch.zeros((h, w, 3), device=dev)
    depth = torch.zeros((h, w), device=dev)
    if not bool(keep.any()):
        return rgb, depth
    x, y, z, col, d = x[:, keep], y[:, keep], z[:, keep], col[..., keep], d[keep]
    inv_d = 1.0 / d
    # Barycentric planes lambda_i = a_i x + b_i y + c_i, either winding.
    a = torch.stack([(y[1] - y[2]) * inv_d, (y[2] - y[0]) * inv_d, (y[0] - y[1]) * inv_d])
    b = torch.stack([(x[2] - x[1]) * inv_d, (x[0] - x[2]) * inv_d, (x[1] - x[0]) * inv_d])
    nxt = [2, 0, 1]  # the corner each plane's constant is taken at
    c = -a * x[nxt] - b * y[nxt]
    iz = 1.0 / z.clamp_min(1e-8)

    def plane(v):  # the plane of sum_i lambda_i v_i: (a, b, c) each (F,)
        return ((a * v).sum(0), (b * v).sum(0), (c * v).sum(0))

    pz = plane(iz)  # perspective-correct inverse depth
    pc = [plane(col[:, ch] * iz) for ch in range(3)]  # colour over depth
    # The pixels any kept face can reach.
    x0 = int(max(torch.floor(x.min() - 0.5).item(), 0))
    x1 = int(min(torch.ceil(x.max() - 0.5).item() + 1, w))
    y0 = int(max(torch.floor(y.min() - 0.5).item(), 0))
    y1 = int(min(torch.ceil(y.max() - 0.5).item() + 1, h))
    if x1 <= x0 or y1 <= y0:
        return rgb, depth
    py = (torch.arange(y0, y1, device=dev, dtype=torch.float32) + 0.5)[:, None, None]
    px = (torch.arange(x0, x1, device=dev, dtype=torch.float32) + 0.5)[None, :, None]
    best = torch.zeros((y1 - y0, x1 - x0), device=dev)
    win = torch.full((y1 - y0, x1 - x0), -1, dtype=torch.long, device=dev)
    for f0 in range(0, a.shape[1], FACE_CHUNK):
        sl = slice(f0, f0 + FACE_CHUNK)
        inside = None
        for i in range(3):
            edge = a[i, sl] * px + b[i, sl] * py + c[i, sl] >= 0
            inside = edge if inside is None else inside & edge
        inv_z = pz[0][sl] * px + pz[1][sl] * py + pz[2][sl]
        zc, arg = torch.where(inside, inv_z, 0.0).max(-1)
        upd = zc > best
        best = torch.where(upd, zc, best)
        win = torch.where(upd, arg + f0, win)
    hit = best > 0
    fi = win.clamp_min(0)
    num = torch.stack([p[0][fi] * px[..., 0] + p[1][fi] * py[..., 0] + p[2][fi] for p in pc], -1)
    inv = 1.0 / best.clamp_min(1e-9)
    rgb[y0:y1, x0:x1] = torch.where(hit[..., None], num * inv[..., None], 0.0)
    depth[y0:y1, x0:x1] = torch.where(hit, inv, 0.0)
    return rgb, depth


def render(objects, class_idx, poses, ks, size, light=(1.0, 0.0, (0.0, 0.0, -1.0))):
    """A batch of one object each -> rgb (B, H, W, 3), depth (B, H, W)."""
    out = [render_one(objects.tri_pos[c], objects.tri_col[c], objects.tri_nrm[c],
                      objects.cull[c], poses[i], ks[i], size, light)
           for i, c in enumerate(class_idx.tolist())]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])
