"""On-device synthesis of training pairs (torch).

Port of ``deepim_tpu/data/synthetic.py`` (``random_lighting``,
``synthetic_batch``, ``synthetic_occlusion_batch``): a whole batch — GT
pose, perturbed source pose, an observed full-frame render under random
lighting over a noise background — is drawn and rendered on the device,
with no input pipeline.  Every draw comes from one explicit
``torch.Generator``, on its device; the assets must lie there too.

The port has one render path, chosen by the tensors' device, so the
reference's ``renderer`` argument (and its per-object "xla" merge, now a
test oracle) is gone.
"""

from __future__ import annotations

from typing import Any

import torch

from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
from deepim_tpu_torch.raster.raster_ref import Lighting
from deepim_tpu_torch.refine.refiner import RenderAssets, gather_class, render_crops, render_scene


def random_lighting(generator: torch.Generator) -> Lighting:
    """Random point + ambient light, as 0-d/(3,) tensors on the generator's
    device: ambient U(0.4, 0.9), diffuse U(0.2, 0.8), a gaussian direction
    normalised and turned to the camera's hemisphere (z <= -0.2)."""
    dev = generator.device
    ambient = 0.4 + 0.5 * torch.rand((), generator=generator, device=dev)
    diffuse = 0.2 + 0.6 * torch.rand((), generator=generator, device=dev)
    d = torch.randn((3,), generator=generator, device=dev)
    d = d / torch.linalg.vector_norm(d).clamp_min(1e-6)
    d = torch.cat([d[:2], -d[2:].abs() - 0.2])
    return Lighting(ambient=ambient, diffuse=diffuse, direction=d)


def _draw_pairs(generator, num_classes: int, batch_size: int, k, image_size,
                rot_noise_deg=15.0, rot_max_deg=45.0, trans_noise=(0.01, 0.01, 0.05),
                trans_max=(0.03, 0.03, 0.15), z_range=(0.5, 1.4)):
    """Classes (B,), GT poses and perturbed source poses (B, 3, 4)."""
    class_idx = torch.randint(0, num_classes, (batch_size,), generator=generator,
                              device=generator.device)
    pose_tgt = sample_poses_in_frustum(generator, batch_size, k, image_size, z_range)
    pose_src = perturb_poses(generator, pose_tgt, rot_noise_deg, rot_max_deg,
                             trans_noise, trans_max)
    return class_idx, pose_tgt, pose_src


def synthetic_batch(generator: torch.Generator, assets: RenderAssets, batch_size: int,
                    k: torch.Tensor, image_size: tuple[int, int],
                    rot_noise_deg: float = 15.0, rot_max_deg: float = 45.0,
                    trans_noise: tuple = (0.01, 0.01, 0.05),
                    trans_max: tuple = (0.03, 0.03, 0.15),
                    z_range: tuple = (0.5, 1.4), bg_noise: bool = True) -> dict[str, Any]:
    """One batch of render-and-compare pairs.

    Returns ``{obs_rgb, obs_depth, obs_mask, pose_src, pose_tgt, k,
    class_idx}``; the observed data is the full camera frame (``k`` (3, 3))
    rendered at the GT pose under one random light for the batch.
    """
    b = batch_size
    class_idx, pose_tgt, pose_src = _draw_pairs(
        generator, assets.num_classes, b, k, image_size, rot_noise_deg, rot_max_deg,
        trans_noise, trans_max, z_range)
    ks = k.to(pose_tgt.device).expand(b, 3, 3).contiguous()
    obs_rgb, obs_depth = render_crops(gather_class(assets, class_idx), pose_tgt, ks,
                                      image_size, lighting=random_lighting(generator))
    obs_mask = obs_depth > 0
    if bg_noise:
        bg = torch.rand(obs_rgb.shape, generator=generator, device=generator.device)
        obs_rgb = torch.where(obs_mask[..., None], obs_rgb, bg)
    return {"obs_rgb": obs_rgb, "obs_depth": obs_depth, "obs_mask": obs_mask,
            "pose_src": pose_src, "pose_tgt": pose_tgt, "k": ks, "class_idx": class_idx}


def _draw_scene(generator, num_classes: int, batch_size: int, k, image_size,
                num_distractors=2, rot_noise_deg=15.0, rot_max_deg=45.0,
                trans_noise=(0.01, 0.01, 0.05), trans_max=(0.03, 0.03, 0.15),
                z_range=(0.5, 1.4)) -> dict[str, Any]:
    """Every draw of ``synthetic_occlusion_batch`` before its render, in
    its order: the pairs, then the distractors, then the light."""
    b, nd = batch_size, num_distractors
    class_idx, pose_tgt, pose_src = _draw_pairs(
        generator, num_classes, b, k, image_size, rot_noise_deg, rot_max_deg,
        trans_noise, trans_max, z_range)
    # Distractors: other classes at poses jittered around the target's.
    d_cls = torch.randint(0, num_classes, (b, nd), generator=generator,
                          device=generator.device)
    d_poses = perturb_poses(generator, pose_tgt.repeat_interleave(nd, dim=0),
                            rot_std_deg=60.0, rot_max_deg=180.0,
                            trans_std=(0.06, 0.06, 0.08),
                            trans_max=(0.15, 0.15, 0.2)).reshape(b, nd, 3, 4)
    return {
        "class_idx": class_idx, "pose_tgt": pose_tgt, "pose_src": pose_src,
        "scene_cls": torch.cat([class_idx[:, None], d_cls], dim=1),
        "scene_poses": torch.cat([pose_tgt[:, None], d_poses], dim=1),
        "lighting": random_lighting(generator),
    }


def synthetic_occlusion_batch(generator: torch.Generator, assets: RenderAssets,
                              batch_size: int, k: torch.Tensor,
                              image_size: tuple[int, int], num_distractors: int = 2,
                              rot_noise_deg: float = 15.0, rot_max_deg: float = 45.0,
                              trans_noise: tuple = (0.01, 0.01, 0.05),
                              trans_max: tuple = (0.03, 0.03, 0.15),
                              z_range: tuple = (0.5, 1.4)) -> dict[str, Any]:
    """Occlusion batch (the Occluded-LINEMOD protocol).

    The observed frame is a multi-object scene (``render_scene``): the
    target at its GT pose plus ``num_distractors`` other objects at nearby
    poses, depth-tested against each other.  ``obs_mask`` is the target's
    visible mask (scene depth within 5 mm of the target-only depth) and
    ``visible_frac`` its share of the target's silhouette.
    """
    b = batch_size
    s = _draw_scene(generator, assets.num_classes, b, k, image_size, num_distractors,
                    rot_noise_deg, rot_max_deg, trans_noise, trans_max, z_range)
    dev = s["pose_tgt"].device
    ks = k.to(dev).expand(b, 3, 3).contiguous()
    valid = torch.ones((b, 1 + num_distractors), dtype=torch.bool, device=dev)
    scene_rgb, scene_depth = render_scene(assets, s["scene_cls"], s["scene_poses"],
                                          valid, ks, image_size, lighting=s["lighting"])
    # Target-only depth for the visibility mask.
    _, tgt_depth = render_crops(gather_class(assets, s["class_idx"]), s["pose_tgt"], ks,
                                image_size)
    visible = ((tgt_depth > 0) & (scene_depth >= tgt_depth - 1e-4)
               & ((scene_depth - tgt_depth).abs() < 5e-3))
    bg = torch.rand(scene_rgb.shape, generator=generator, device=generator.device)
    obs_rgb = torch.where((scene_depth > 0)[..., None], scene_rgb, bg)
    return {
        "obs_rgb": obs_rgb,
        "obs_depth": scene_depth,
        "obs_mask": visible,
        "pose_src": s["pose_src"],
        "pose_tgt": s["pose_tgt"],
        "k": ks,
        "class_idx": s["class_idx"],
        "visible_frac": visible.sum((1, 2)) / (tgt_depth > 0).sum((1, 2)).clamp_min(1),
    }
