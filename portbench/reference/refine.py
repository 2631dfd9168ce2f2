"""Render-and-compare refinement and the synthetic training step, in the
reference's own pieces.

:func:`synthetic_rows` re-derives rows of a synthetic batch from its seed:
the draws, the observed frame rendered at the GT pose under the batch's
light, the background noise where nothing was drawn.
:func:`refine` runs K iterations (the first ``coarse_iters`` at half size):
zoom box from the current pose, render into the crop, crop the observed
frame, the network, the quaternion normalised, the translation clipped to
(2000, 2000, 4), the pose composed.  :func:`train_steps` runs the training
step: the losses of ``train_iter`` iterations, each refining from the
last, the gradient, a clip of the global norm and Adam.
"""

from __future__ import annotations

import torch

from portbench.reference import losses, network, zoom
from portbench.reference.geometry import apply_delta, draw_background, draw_batch, quat_normalize
from portbench.reference.render import render

TRANS_CLIP = (2000.0, 2000.0, 4.0)


def synthetic_rows(objects, seed: int, device, b: int, k, size, noise: dict, rows=None) -> dict:
    """Rows ``rows`` (default all) of the synthetic batch drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = draw_batch(g, len(objects.names), b, k, size, noise)
    bg = draw_background(g, (b, *size, 3))
    rows = torch.arange(b, device=device) if rows is None else torch.as_tensor(rows, device=device)
    cls, tgt = d["class_idx"][rows], d["pose_tgt"][rows]
    ks = k.expand(len(rows), 3, 3)
    rgb, depth = render(objects, cls, tgt, ks, size, d["light"])
    mask = depth > 0
    return {"obs_rgb": torch.where(mask[..., None], rgb, bg[rows]), "obs_depth": depth,
            "obs_mask": mask, "pose_src": d["pose_src"][rows], "pose_tgt": tgt, "k": ks,
            "class_idx": cls}


def inputs(objects, obs_rgb, pose, k, cls, out_size):
    box = zoom.zoom_box(pose, k, objects.corners[cls], out_size)
    kz = zoom.crop_k(k, box)
    ren, depth = render(objects, cls, pose, kz, out_size)
    obs = zoom.crop(obs_rgb, box, out_size)
    return torch.cat([obs - 0.5, ren - 0.5], -1), box, kz, depth


def pose_head(out, cls):
    rows = torch.arange(cls.shape[0], device=cls.device)
    return quat_normalize(out["rot_raw"][rows, cls]), out["trans"][rows, cls]


def refine(params, objects, obs_rgb, init, k, cls, iters, coarse_iters, out_size,
           head_grid, quant=None):
    pose = init
    clip = torch.tensor(TRANS_CLIP, device=init.device)
    for it in range(iters):
        size = (out_size[0] // 2, out_size[1] // 2) if it < coarse_iters else out_size
        x, _, kz, _ = inputs(objects, obs_rgb, pose, k, cls, size)
        quat, trans = pose_head(network.forward(params, x, head_grid, quant=quant), cls)
        pose = apply_delta(pose, quat, trans.clamp(-clip, clip), kz)
    return pose


def step_losses(params, objects, batch, train: dict, out_size, head_grid, quant=None):
    """The summed loss of ``train_iter`` iterations (one autograd graph)."""
    cls, pose_src, pose_tgt = batch["class_idx"], batch["pose_src"], batch["pose_tgt"]
    total = 0.0
    for _ in range(train["train_iter"]):
        with torch.no_grad():
            x, box, kz, ren_depth = inputs(objects, batch["obs_rgb"], pose_src, batch["k"], cls,
                                           out_size)
        out = network.forward(params, x, head_grid, pose_only=False, decoder=True, mask=True,
                              quant=quant)
        quat, trans = pose_head(out, cls)
        sym = train["sym_aware_pm"]
        pm = losses.point_matching(objects.points[cls], quat, trans, pose_src, pose_tgt, kz,
                                   objects.sym_poses[cls] if sym else None,
                                   objects.continuous[cls] if sym else None)
        with torch.no_grad():
            depth_obs = zoom.crop(batch["obs_depth"][..., None], box, out_size,
                                  nearest=True)[..., 0]
            mask_obs = zoom.crop(batch["obs_mask"][..., None].to(torch.float32), box, out_size,
                                 nearest=True)[..., 0]
            gt, valid = losses.flow_gt(ren_depth, pose_src, pose_tgt, kz, depth_obs,
                                       stride=train["flow_occ_stride"])
        total = (total + train["w_pm"] * pm.mean()
                 + train["w_flow"] * losses.flow_epe(out["flow"], gt, valid).mean()
                 + train["w_mask"] * losses.mask_ce(out["mask_logit"], mask_obs).mean())
        pose_src = apply_delta(pose_src, quat, trans, kz).detach()
    return total


def learning_rate(train: dict, count: int) -> float:
    """Linear warm-up from 0, then steps down by ``lr_decay_factor``."""
    if count < train["warmup_steps"]:
        frac = 1.0 - max(count, 0) / train["warmup_steps"]
        return (0.0 - train["lr"]) * frac + train["lr"]
    lr = train["lr"]
    for b in train["lr_decay_steps"]:
        if count - train["warmup_steps"] >= b:
            lr *= train["lr_decay_factor"]
    return lr


def train_steps(params: dict, objects, batches, train: dict, out_size, head_grid,
                quant=None, row_block: int = 8) -> dict:
    """Train ``params`` (updated in place) on ``batches`` in turn -> each
    step's loss, the first step's clipped gradient and the Adam moments.
    Rows go through the network in blocks of ``row_block``; the loss is
    their mean, so the gradient is the whole batch's."""
    names = list(params)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    out = {"loss": [], "grad": None}
    for count, batch in enumerate(batches):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        b = batch["class_idx"].shape[0]
        total = 0.0
        for r0 in range(0, b, row_block):
            part = {key: val[r0:r0 + row_block] for key, val in batch.items()}
            loss = step_losses(params, objects, part, train, out_size, head_grid, quant)
            (loss * (part["class_idx"].shape[0] / b)).backward()
            total += float(loss.detach()) * part["class_idx"].shape[0] / b
        out["loss"].append(total)
        with torch.no_grad():
            grads = {n: params[n].grad for n in names}
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
            scale = 1.0 if norm < train["grad_clip"] else train["grad_clip"] / norm
            grads = {n: g * scale for n, g in grads.items()}
            if count == 0:
                out["grad"] = {n: g.clone() for n, g in grads.items()}
            lr = learning_rate(train, count)
            b1, b2, eps = 0.9, 0.999, 1e-8
            for n in names:
                m[n].mul_(b1).add_(grads[n], alpha=1 - b1)
                v[n].mul_(b2).addcmul_(grads[n], grads[n], value=1 - b2)
                mh = m[n] / (1 - b1 ** (count + 1))
                vh = v[n] / (1 - b2 ** (count + 1))
                params[n].sub_(lr * mh / (vh.sqrt() + eps))
        for p in params.values():
            p.requires_grad_(False)
            p.grad = None
    return out
