"""Published peaks of one NVIDIA H100 (SXM, dense, at its 700 W limit) and
the least time a render could take.

A render of B crops of H x W must write its outputs (depth and three
colour channels, 16 B a pixel) and read, once, the coverage and depth
planes (12 floats, 48 B) of every face it keeps and that reaches the
image, and it must test each such face at every pixel centre of its
bounding box inside the image (16 fp32 operations a pair).  The least
time is the larger of the bytes over the memory rate and the operations
over the fp32 rate.  Nothing here depends on how the renderer under test
bins or walks its faces; the colour planes of the faces that win a pixel
are left out, so the bound is a lower one.
"""

from __future__ import annotations

import torch

from portbench.reference import zoom
from portbench.reference.render import Z_NEAR

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
OPS_PER_PAIR = 16
PLANE_BYTES = 48
OUT_BYTES_PER_PIXEL = 16


def _centres(lo, hi, n):
    first = torch.ceil(lo - 0.5).clamp_min(0)
    last = torch.floor(hi - 0.5).clamp_max(n - 1)
    return (last - first + 1).clamp_min(0)


def render_work(objects, cls, poses, ks, size) -> tuple[float, float]:
    """(bytes, operations) of rendering each row's object at its pose."""
    h, w = size
    nbytes = float(OUT_BYTES_PER_PIXEL * poses.shape[0] * h * w)
    ops = 0.0
    for c in cls.unique().tolist():
        sel = cls == c
        p, k = poses[sel], ks[sel]
        tri = objects.tri_pos[c].reshape(3, 3, -1).double()
        r, t = p[:, :, :3].double(), p[:, :, 3].double()
        cam = torch.einsum("bij,cjf->bcif", r, tri) + t[:, None, :, None]
        z = cam[:, :, 2]
        x = k[:, None, 0, 0, None].double() * cam[:, :, 0] / z + k[:, None, 0, 2, None].double()
        y = k[:, None, 1, 1, None].double() * cam[:, :, 1] / z + k[:, None, 1, 2, None].double()
        d = (y[:, 1] - y[:, 2]) * (x[:, 0] - x[:, 2]) + (x[:, 2] - x[:, 1]) * (y[:, 0] - y[:, 2])
        cull = objects.cull[c].double()
        keep = (z > Z_NEAR).all(1) & (d.abs() > 1e-12) & ((cull == 0) | (d * cull < 0))
        nx = _centres(x.amin(1), x.amax(1), w)
        ny = _centres(y.amin(1), y.amax(1), h)
        reach = keep & (nx > 0) & (ny > 0)
        nbytes += PLANE_BYTES * float(reach.sum())
        ops += OPS_PER_PAIR * float((nx * ny * reach).sum())
    return nbytes, ops


def render_bound_s(objects, cls, poses, ks, size) -> float:
    nbytes, ops = render_work(objects, cls, poses, ks, size)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def refine_render_bound_s(objects, cls, trajectory, k, iters, coarse_iters, out_size) -> float:
    """The bound of the K crop renders of one refine call, from the poses
    each iteration started from (``trajectory`` (K + 1, B, 3, 4))."""
    total = 0.0
    for it in range(iters):
        size = (out_size[0] // 2, out_size[1] // 2) if it < coarse_iters else out_size
        pose = trajectory[it]
        box = zoom.zoom_box(pose, k, objects.corners[cls], size)
        total += render_bound_s(objects, cls, pose, zoom.crop_k(k, box), size)
    return total
