"""Rotations, rigid transforms, the untangled pose update and the seeded
draws of a synthetic batch (plain PyTorch, float32).

The draws take the same calls of one ``torch.Generator`` in the same order
as the synthetic generator they stand beside: classes, a uniform random
rotation, depth and image position, the source pose's euler and
translation noise, the light, then the background noise.  On one device
type the same seed gives the same numbers, so the reference re-derives a
batch from its seed instead of reading it.
"""

from __future__ import annotations

import math

import torch


def mm(a, b):
    """(..., n, k) @ (..., k, m) as a broadcast product and sum: true float32."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def mv(r, v):
    return (r * v.unsqueeze(-2)).sum(-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-8)


def quat2mat(q):
    w, x, y, z = quat_normalize(q).unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def euler2mat(ax, ay, az):
    """Static sxyz: Rz @ Ry @ Rx."""
    cx, sx, cy, sy, cz, sz = (torch.cos(ax), torch.sin(ax), torch.cos(ay), torch.sin(ay),
                              torch.cos(az), torch.sin(az))
    m = torch.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz,
                     cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz,
                     -sy, sx * cy, cx * cy], -1)
    return m.reshape(ax.shape + (3, 3))


def transform(points, pose):
    """Object points (..., N, 3) by pose (..., 3, 4)."""
    return mv(pose[..., :3].unsqueeze(-3), points) + pose[..., 3][..., None, :]


def compose(a, b):
    """The pose that maps through ``b`` then ``a``."""
    return torch.cat([mm(a[..., :3], b[..., :3]),
                      (mv(a[..., :3], b[..., 3]) + a[..., 3])[..., None]], -1)


def apply_delta(pose, quat, trans, k):
    """DeepIM's untangled update: R' = ΔR R about the object centre;
    x/z and y/z move by (vx / fx, vy / fy) and z' = z exp(-vz)."""
    r = mm(quat2mat(quat), pose[..., :3])
    t = pose[..., 3]
    zs = t[..., 2]
    zt = zs * torch.exp(-trans[..., 2])
    xt = (trans[..., 0] / k[..., 0, 0] + t[..., 0] / zs) * zt
    yt = (trans[..., 1] / k[..., 1, 1] + t[..., 1] / zs) * zt
    return torch.cat([r, torch.stack([xt, yt, zt], -1)[..., None]], -1)


def rotation_gap_deg(ra, rb):
    tr = mm(ra, rb.transpose(-1, -2)).diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0, 1.0)))


# -- the synthetic batch's draws ----------------------------------------------


def _uniform(g, n, lo, hi):
    return lo + (hi - lo) * torch.rand((n,), generator=g, device=g.device)


def draw_batch(g: torch.Generator, num_classes: int, b: int, k, size, noise: dict,
               z_range=(0.5, 1.4), border=0.25) -> dict:
    """Classes, GT poses in the camera's frustum, perturbed source poses
    and a random light, drawn in the synthetic generator's order; the
    background noise is drawn last, after the render, by :func:`draw_background`."""
    dev = g.device
    h, w = size
    cls = torch.randint(0, num_classes, (b,), generator=g, device=dev)
    q = quat_normalize(torch.randn((b, 4), generator=g, device=dev))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    r = quat2mat(q)
    z = _uniform(g, b, *z_range)
    u = _uniform(g, b, border * w, (1 - border) * w)
    v = _uniform(g, b, border * h, (1 - border) * h)
    t = torch.stack([(u - k[0, 2]) / k[0, 0] * z, (v - k[1, 2]) / k[1, 1] * z, z], -1)
    pose_tgt = torch.cat([r, t[..., None]], -1)
    rmax = math.radians(noise["rot_max_deg"])
    ang = (torch.randn((b, 3), generator=g, device=dev)
           * math.radians(noise["rot_deg"])).clamp(-rmax, rmax)
    std = torch.tensor(noise["trans"], device=dev)
    tmax = torch.tensor(noise["trans_max"], device=dev)
    dt = torch.randn((b, 3), generator=g, device=dev)
    dt = torch.maximum(torch.minimum(dt * std, tmax), -tmax)
    ts = pose_tgt[..., 3] + dt
    ts = torch.cat([ts[:, :2], ts[:, 2:].clamp_min(0.1)], -1)
    pose_src = torch.cat([mm(euler2mat(ang[:, 0], ang[:, 1], ang[:, 2]), r), ts[..., None]], -1)
    ambient = 0.4 + 0.5 * torch.rand((), generator=g, device=dev)
    diffuse = 0.2 + 0.6 * torch.rand((), generator=g, device=dev)
    d = torch.randn((3,), generator=g, device=dev)
    d = d / torch.linalg.vector_norm(d).clamp_min(1e-6)
    d = torch.cat([d[:2], -d[2:].abs() - 0.2])
    return {"class_idx": cls, "pose_tgt": pose_tgt, "pose_src": pose_src,
            "light": (ambient, diffuse, d)}


def draw_background(g: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device)
