"""Training losses: point matching, flow end-point error, mask cross-entropy.

Port of ``deepim_tpu/losses/losses.py`` (``_optimal_z_angle``,
``_rz_pose``, ``point_matching_loss``, ``_downsample_flow``,
``flow_epe_loss``, ``mask_ce_loss``, ``angle_trans_l1_loss``).  Each loss
is per sample, (B,), differentiated by autograd.  The reference's ``vmap``
over the symmetry set is a broadcast over an S axis here, and its
``jnp.min`` is ``torch.amin``, which splits the gradient between tied
entries as JAX does (identity-padded symmetry sets tie).
"""

from __future__ import annotations

import torch

from deepim_tpu_torch.config.config import FLOW_LEVEL_WEIGHTS
from deepim_tpu_torch.geometry.delta_pose import DeltaPose, apply_delta
from deepim_tpu_torch.geometry.se3 import _mv, se3_mul, transform_points


def _optimal_z_angle(points: torch.Tensor, p_est: torch.Tensor,
                     pose_tgt: torch.Tensor) -> torch.Tensor:
    """Closed-form rotation angle about object z that best aligns the target
    pose's points with ``p_est`` -> (B,).

    With w = R_tᵀ(p_est − t_t), the xy part is a 2-D Procrustes problem:
    maximise A cosθ + B sinθ, A = Σ(w_x x_x + w_y x_y),
    B = Σ(w_y x_x − w_x x_y), so θ* = atan2(B, A) (differentiable).
    """
    r_t = pose_tgt[..., :3]
    t_t = pose_tgt[..., 3][..., None, :]
    w = _mv(r_t.transpose(-1, -2).unsqueeze(-3), p_est - t_t)
    x = points
    a = (w[..., 0] * x[..., 0] + w[..., 1] * x[..., 1]).sum(-1)
    b = (w[..., 1] * x[..., 0] - w[..., 0] * x[..., 1]).sum(-1)
    return torch.atan2(b, a)


def _rz_pose(theta: torch.Tensor) -> torch.Tensor:
    """(B,) angles -> (B, 3, 4) object-frame z-rotation transforms."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    r = torch.stack([torch.stack([c, -s, z], -1),
                     torch.stack([s, c, z], -1),
                     torch.stack([z, z, o], -1)], -2)
    return torch.cat([r, torch.zeros(*theta.shape, 3, 1, dtype=theta.dtype,
                                      device=theta.device)], -1)


def point_matching_loss(points: torch.Tensor, delta: DeltaPose, pose_src: torch.Tensor,
                        pose_tgt: torch.Tensor, k: torch.Tensor,
                        sym_poses: torch.Tensor | None = None,
                        sym_continuous: torch.Tensor | None = None) -> torch.Tensor:
    """Mean-L1 point-matching loss per sample -> (B,).

    ``points`` (B, N, 3) object-frame model points; ``delta`` the predicted
    untangled delta in the intrinsics ``k`` (B, 3, 3); poses (B, 3, 4).
    With ``sym_poses`` (B, S, 3, 4) object symmetries (identity included)
    the loss is the min over the targets pose_tgt ∘ G_s; samples flagged
    ``sym_continuous`` (B,) bool also take the closed-form best rotation
    about z (:func:`_optimal_z_angle`) into that min.
    """
    def posed(pts, pose):
        return transform_points(pts, pose[..., :3], pose[..., 3])

    def l1(a, b):  # mean over points and coordinates
        return (a - b).abs().mean((-1, -2))

    p_est = posed(points, apply_delta(pose_src, delta, k))
    if sym_poses is None:
        return l1(p_est, posed(points, pose_tgt))
    tgt_syms = se3_mul(pose_tgt[..., None, :, :], sym_poses)  # (B, S, 3, 4)
    d = torch.amin(l1(p_est.unsqueeze(-3), posed(points.unsqueeze(-3), tgt_syms)), dim=-1)
    if sym_continuous is not None:
        theta = _optimal_z_angle(points, p_est, pose_tgt)
        d_cont = l1(p_est, posed(points, se3_mul(pose_tgt, _rz_pose(theta))))
        d = torch.where(sym_continuous, torch.minimum(d, d_cont), d)
    return d


def _downsample_flow(flow: torch.Tensor, valid: torch.Tensor, factor: int):
    """Average-pool GT flow (B, H, W, 2) over its valid pixels to 1/factor
    -> (pooled flow, pooled valid).  A pooled pixel is valid if any of its
    pixels was; flow stays in input-resolution pixels.  The ragged border
    (less than one cell) is cropped."""
    b, h, w, _ = flow.shape
    f = factor
    hp, wp = (h // f) * f, (w // f) * f
    fv = (flow * valid[..., None])[:, :hp, :wp]
    fv = fv.reshape(b, h // f, f, w // f, f, 2).sum((2, 4))
    cnt = valid[:, :hp, :wp].reshape(b, h // f, f, w // f, f).sum((2, 4))
    return fv / cnt[..., None].clamp_min(1.0), cnt > 0


def flow_epe_loss(flow_preds: dict[int, torch.Tensor], flow_gt: torch.Tensor,
                  valid: torch.Tensor,
                  weights: dict[int, float] = FLOW_LEVEL_WEIGHTS) -> torch.Tensor:
    """Weighted multi-scale end-point error -> (B,).

    ``flow_preds`` {level: (B, H/2^l, W/2^l, 2)}; ``flow_gt`` (B, H, W, 2)
    src -> tgt in input pixels; ``valid`` (B, H, W) bool.
    """
    total = torch.zeros(flow_gt.shape[0], dtype=torch.float32, device=flow_gt.device)
    validf = valid.to(torch.float32)
    for lvl, pred in flow_preds.items():
        gt, v = _downsample_flow(flow_gt, validf, 2 ** lvl)
        hh, ww = min(pred.shape[1], gt.shape[1]), min(pred.shape[2], gt.shape[2])
        pred, gt, v = pred[:, :hh, :ww], gt[:, :hh, :ww], v[:, :hh, :ww]
        epe = torch.sqrt(((pred - gt) ** 2).sum(-1) + 1e-12)
        epe = torch.where(v, epe, 0.0)
        per = epe.sum((1, 2)) / v.sum((1, 2)).to(torch.float32).clamp_min(1.0)
        total = total + weights.get(lvl, 0.0) * per
    return total


def mask_ce_loss(mask_logit: torch.Tensor, mask_gt: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE between the foreground logit (B, h, w, 1) and the mask
    (B, H, W), average-pooled down to the logit's scale -> (B,)."""
    b, h, w, _ = mask_logit.shape
    hf, wf = mask_gt.shape[1] // h, mask_gt.shape[2] // w
    gt = mask_gt.to(torch.float32)[:, : h * hf, : w * wf]
    gt = gt.reshape(b, h, hf, w, wf).mean((2, 4))
    logit = mask_logit[..., 0]
    ce = logit.clamp_min(0.0) - logit * gt + torch.log1p(torch.exp(-logit.abs()))
    return ce.mean((1, 2))


def angle_trans_l1_loss(delta: DeltaPose, delta_gt: DeltaPose
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct L1 on the untangled delta (``train.pose_loss="separate"``):
    quaternions up to sign, and the translation -> (B,), (B,)."""
    q_p, q_g = delta.quat, delta_gt.quat
    rot = torch.minimum((q_p - q_g).abs().sum(-1), (q_p + q_g).abs().sum(-1))
    trans = (delta.trans - delta_gt.trans).abs().sum(-1)
    return rot, trans
