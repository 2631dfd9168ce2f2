"""Ground-truth optical flow between the rendered and the observed view.

Port of ``deepim_tpu/ops/flow_gt.py §calc_flow``, batched over B where the
reference is vmapped: back-project the rendered depth at the source pose,
move the points through the relative pose (src -> tgt), re-project, and
report each pixel's displacement; optionally keep only the pixels the
observed (target-pose) depth does not occlude.

Torch ops, not a kernel (the reference's is plain jax too).  The visibility
check is a scattered gather from the observed depth
(:func:`~deepim_tpu_torch.ops.resample.nearest_sample`); the train step
times it on the card.
"""

from __future__ import annotations

import torch

from deepim_tpu_torch.geometry.se3 import se3_inverse, se3_mul
from deepim_tpu_torch.ops.resample import nearest_sample


def calc_flow(depth_src: torch.Tensor, pose_src: torch.Tensor, pose_tgt: torch.Tensor,
              k: torch.Tensor, depth_tgt: torch.Tensor | None = None,
              occlusion_tol: float = 0.02, occlusion_stride: int = 1
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (flow (B, H, W, 2) src -> tgt in pixels, valid (B, H, W) bool).

    ``depth_src`` (B, H, W) rendered depth at ``pose_src`` (0 = background),
    poses (B, 3, 4), ``k`` (B, 3, 3).  ``valid`` is the rendered foreground,
    intersected with the visibility check when ``depth_tgt`` (B, H, W) is
    given: the point lies no more than ``occlusion_tol`` metres behind the
    observed surface.  ``occlusion_stride`` s > 1 checks each s-px block at
    its centre pixel (offset s // 2) and nearest-upsamples the result,
    extending the last block row and column where H or W is not a multiple
    of s.  Invalid pixels have flow 0.
    """
    b, h, w = depth_src.shape
    dev = depth_src.device
    fx, fy = k[:, 0, 0, None, None], k[:, 1, 1, None, None]
    cx, cy = k[:, 0, 2, None, None], k[:, 1, 2, None, None]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + 0.5
    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + 0.5

    fg = depth_src > 0
    z = torch.where(fg, depth_src, 1.0)
    pts = ((u - cx) / fx * z, (v - cy) / fy * z, z)  # camera frame at src

    rel = se3_mul(pose_tgt, se3_inverse(pose_src))  # src camera -> tgt camera
    r, t = rel[:, :, :3, None, None], rel[:, :, 3, None, None]
    x_t, y_t, z_t = (r[:, i, 0] * pts[0] + r[:, i, 1] * pts[1] + r[:, i, 2] * pts[2]
                     + t[:, i] for i in range(3))
    z_t = z_t.clamp_min(1e-6)
    u_t = fx * x_t / z_t + cx
    v_t = fy * y_t / z_t + cy

    flow = torch.stack([u_t - u, v_t - v], dim=-1)
    valid = fg
    if depth_tgt is not None:
        s = occlusion_stride
        o = s // 2 if s > 1 else 0
        coords = torch.stack([u_t[:, o::s, o::s], v_t[:, o::s, o::s]], dim=-1)
        obs = nearest_sample(depth_tgt[..., None], coords, fill_value=0.0)[..., 0]
        visible = (obs > 0) & (z_t[:, o::s, o::s] <= obs + occlusion_tol)
        if s > 1:
            rows = (torch.arange(h, device=dev) // s).clamp_max(visible.shape[1] - 1)
            cols = (torch.arange(w, device=dev) // s).clamp_max(visible.shape[2] - 1)
            visible = visible[:, rows[:, None], cols[None, :]]
        valid = valid & visible
    flow = torch.where(valid[..., None], flow, 0.0)
    return flow, valid
