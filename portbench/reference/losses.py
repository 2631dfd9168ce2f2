"""Training targets and losses (plain PyTorch, float32).

- Point matching (DeepIM §3.3): the mean L1 distance of the object's
  surface sample under the predicted and the GT pose; for a symmetric
  object the least over its symmetry set, and for a continuous z symmetry
  also over the closed-form best angle about z.
- Flow GT: back-project the rendered depth at the source pose, move it to
  the GT pose, re-project; a pixel counts where it is foreground and the
  observed depth, read at each 4 px block's centre, does not hide it by
  more than 2 cm.
- Flow loss: end-point error at each decoder level against the GT flow
  average-pooled over its valid pixels, weighted 0.32, 0.08, 0.04, 0.02,
  0.01 from 1/64 to 1/4.
- Mask loss: sigmoid cross-entropy against the observed mask averaged
  down to the logit's 1/4 scale.
"""

from __future__ import annotations

import torch

from portbench.reference.geometry import apply_delta, compose, mv, transform

FLOW_WEIGHTS = {6: 0.32, 5: 0.08, 4: 0.04, 3: 0.02, 2: 0.01}


def point_matching(points, quat, trans, pose_src, pose_tgt, k, sym_poses, continuous):
    p_est = transform(points, apply_delta(pose_src, quat, trans, k))

    def l1(a, b):
        return (a - b).abs().mean((-1, -2))

    if sym_poses is None:
        return l1(p_est, transform(points, pose_tgt))
    tgt = compose(pose_tgt[:, None], sym_poses)  # (B, S, 3, 4)
    d = torch.amin(l1(p_est[:, None], transform(points[:, None], tgt)), -1)
    r_t, t_t = pose_tgt[..., :3], pose_tgt[..., 3][:, None]
    w = mv(r_t.transpose(-1, -2).unsqueeze(-3), p_est - t_t)
    a = (w[..., 0] * points[..., 0] + w[..., 1] * points[..., 1]).sum(-1)
    b = (w[..., 1] * points[..., 0] - w[..., 0] * points[..., 1]).sum(-1)
    th = torch.atan2(b, a)
    c, s, zero, one = torch.cos(th), torch.sin(th), torch.zeros_like(th), torch.ones_like(th)
    rz = torch.stack([torch.stack([c, -s, zero, zero], -1), torch.stack([s, c, zero, zero], -1),
                      torch.stack([zero, zero, one, zero], -1)], -2)
    d_cont = l1(p_est, transform(points, compose(pose_tgt, rz)))
    return torch.where(continuous, torch.minimum(d, d_cont), d)


def flow_gt(depth_src, pose_src, pose_tgt, k, depth_obs, tol=0.02, stride=4):
    b, h, w = depth_src.shape
    dev = depth_src.device
    fx, fy = k[:, 0, 0, None, None], k[:, 1, 1, None, None]
    cx, cy = k[:, 0, 2, None, None], k[:, 1, 2, None, None]
    u = torch.arange(w, device=dev, dtype=torch.float32)[None, None] + 0.5
    v = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] + 0.5
    fg = depth_src > 0
    z = torch.where(fg, depth_src, 1.0)
    pts = ((u - cx) / fx * z, (v - cy) / fy * z, z)
    r_s = pose_src[..., :3].transpose(-1, -2)
    inv_src = torch.cat([r_s, -mv(r_s, pose_src[..., 3])[..., None]], -1)
    rel = compose(pose_tgt, inv_src)
    r, t = rel[:, :, :3, None, None], rel[:, :, 3, None, None]
    xt, yt, zt = (r[:, i, 0] * pts[0] + r[:, i, 1] * pts[1] + r[:, i, 2] * pts[2] + t[:, i]
                  for i in range(3))
    zt = zt.clamp_min(1e-6)
    ut, vt = fx * xt / zt + cx, fy * yt / zt + cy
    flow = torch.stack([ut - u, vt - v], -1)
    o = stride // 2
    xi = torch.round(ut[:, o::stride, o::stride] - 0.5)
    yi = torch.round(vt[:, o::stride, o::stride] - 0.5)
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
    seen = torch.gather(depth_obs.reshape(b, -1), 1, idx.reshape(b, -1)).reshape(idx.shape)
    seen = torch.where(inb, seen, 0.0)
    visible = (seen > 0) & (zt[:, o::stride, o::stride] <= seen + tol)
    rows = (torch.arange(h, device=dev) // stride).clamp_max(visible.shape[1] - 1)
    cols = (torch.arange(w, device=dev) // stride).clamp_max(visible.shape[2] - 1)
    valid = fg & visible[:, rows[:, None], cols[None, :]]
    return torch.where(valid[..., None], flow, 0.0), valid


def flow_epe(flows: dict, gt, valid):
    total = torch.zeros(gt.shape[0], device=gt.device)
    vf = valid.to(torch.float32)
    b, h, w, _ = gt.shape
    for lvl, pred in flows.items():
        f = 2 ** lvl
        hp, wp = (h // f) * f, (w // f) * f
        s = (gt * vf[..., None])[:, :hp, :wp].reshape(b, h // f, f, w // f, f, 2).sum((2, 4))
        n = vf[:, :hp, :wp].reshape(b, h // f, f, w // f, f).sum((2, 4))
        g, v = s / n[..., None].clamp_min(1.0), n > 0
        hh, ww = min(pred.shape[1], g.shape[1]), min(pred.shape[2], g.shape[2])
        epe = torch.sqrt(((pred[:, :hh, :ww] - g[:, :hh, :ww]) ** 2).sum(-1) + 1e-12)
        epe = torch.where(v[:, :hh, :ww], epe, 0.0)
        count = v[:, :hh, :ww].sum((1, 2)).clamp_min(1)
        total = total + FLOW_WEIGHTS[lvl] * epe.sum((1, 2)) / count
    return total


def mask_ce(logit, mask):
    b, h, w, _ = logit.shape
    hf, wf = mask.shape[1] // h, mask.shape[2] // w
    gt = mask.to(torch.float32)[:, :h * hf, :w * wf].reshape(b, h, hf, w, wf).mean((2, 4))
    z = logit[..., 0]
    return (z.clamp_min(0.0) - z * gt + torch.log1p(torch.exp(-z.abs()))).mean((1, 2))
