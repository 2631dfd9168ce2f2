"""Multi-hypothesis refinement: refine N inits per image, keep the best.

Port of ``deepim_tpu/refine/hypotheses.py``.  Under heavy occlusion one
init can lock onto the wrong local minimum; refining several perturbed
hypotheses in one batch and scoring each by how well its render agrees
with the observed image rescues such failures at the cost of an N-times
larger batch.

The draw of the hypotheses (:func:`draw_hypotheses`, from a
``torch.Generator``) is split from the refinement and selection
(:func:`select_hypotheses`), so the selection can be given any set of
hypotheses, the reference's draw included.
"""

from __future__ import annotations

import torch

from deepim_tpu_torch.data.pairs import perturb_poses
from deepim_tpu_torch.ops.zoom import (
    ZoomBox, compute_zoom_box, zoom_image_batch, zoom_intrinsics)
from deepim_tpu_torch.refine.refiner import (
    RenderAssets, gather_class, refine_poses, render_crops)


@torch.no_grad()
def score_poses(assets_b: RenderAssets, obs_rgb: torch.Tensor, poses: torch.Tensor,
                k: torch.Tensor, out_size: tuple[int, int],
                obs_depth: torch.Tensor | None = None, trunc: float = 0.25,
                depth_margin: float = 0.02, depth_weight: float = 1.0,
                depth_trunc: float = 0.05, box: ZoomBox | None = None) -> torch.Tensor:
    """Render-vs-observed agreement score per pose -> (N,), higher is better.

    ``assets_b`` are gathered per sample, ``obs_rgb`` (N, H, W, 3) full
    frames, ``poses`` (N, 3, 4), ``k`` (N, 3, 3).  The score is minus the
    mean per-pixel |RGB diff|, capped at ``trunc``, over the rendered
    foreground of each pose's zoom crop.  With ``obs_depth`` (N, H, W;
    metric, 0 = missing), pixels whose observed surface is more than
    ``depth_margin`` nearer than the render are occluded: each is charged
    exactly ``trunc``, so occlusion costs what honest disagreement costs
    and never less.  Visible pixels add a depth-agreement term (|obs -
    rendered| capped at ``depth_trunc``, in ``trunc`` units, weighted
    ``depth_weight``), charged in full where the observation has no
    surface.  A pose that renders nothing scores ``-inf``.

    ``box`` fixes one zoom window per sample instead of each pose's own:
    ranking widely spread candidates (lost-track re-seeds) in their own
    frames favours nearer ones, so they share the incumbent's.
    """
    if box is None:
        box = compute_zoom_box(poses, k, assets_b.corners, out_size)
    kz = zoom_intrinsics(k, box)
    ren_rgb, ren_depth = render_crops(assets_b, poses, kz, out_size)
    obs_crop = zoom_image_batch(obs_rgb, box, out_size)
    fg = (ren_depth > 0).to(torch.float32)
    vis = fg
    diff = (obs_crop - ren_rgb).abs().mean(-1)
    if obs_depth is not None:
        obs_d = zoom_image_batch(obs_depth[..., None], box, out_size,
                                 method="nearest")[..., 0]
        occluded = (obs_d > 0) & (obs_d < ren_depth - depth_margin)
        vis = fg * (1.0 - occluded.to(torch.float32))
        if depth_weight > 0:
            ddiff = torch.where(
                obs_d > 0,
                (obs_d - ren_depth).abs().clamp_max(depth_trunc) * (trunc / depth_trunc),
                depth_trunc * (trunc / depth_trunc))
            diff = diff + depth_weight * ddiff
    diff = diff.clamp_max(trunc) * vis
    fg_count = fg.sum((1, 2))
    occ_count = fg_count - vis.sum((1, 2))
    score = -(diff.sum((1, 2)) + trunc * occ_count) / fg_count.clamp_min(1.0)
    return torch.where(fg_count > 0, score, -torch.inf)


def draw_hypotheses(generator: torch.Generator, init_pose: torch.Tensor,
                    num_hypotheses: int = 4, rot_deg: float = 20.0,
                    trans: tuple = (0.02, 0.02, 0.08)) -> torch.Tensor:
    """(num_hypotheses*B, 3, 4) hypotheses, hypothesis-major: hypothesis 0
    is ``init_pose`` (B, 3, 4) exactly, the others perturb it (gaussian,
    clipped at three standard deviations)."""
    b = init_pose.shape[0]
    reps = init_pose.repeat(num_hypotheses, 1, 1)
    noise = perturb_poses(generator, reps, rot_std_deg=rot_deg, rot_max_deg=3 * rot_deg,
                          trans_std=trans, trans_max=tuple(3 * t for t in trans))
    keep = (torch.arange(reps.shape[0], device=reps.device) < b)[:, None, None]
    return torch.where(keep, reps, noise)


@torch.no_grad()
def select_hypotheses(model, assets: RenderAssets, obs_rgb: torch.Tensor,
                      hyps: torch.Tensor, k: torch.Tensor, class_idx: torch.Tensor,
                      num_iters: int = 4, out_size: tuple[int, int] = (480, 640),
                      obs_mask: torch.Tensor | None = None,
                      obs_depth: torch.Tensor | None = None, coarse_iters: int = 0,
                      coarse_size: tuple[int, int] | None = None,
                      select_margin: float = 0.05) -> tuple[torch.Tensor, torch.Tensor]:
    """Refine the hypothesis-major ``hyps`` (N*B, 3, 4) of each image, score
    each, keep the best -> (best poses (B, 3, 4), scores (B, N)).

    ``obs_rgb``, ``k``, ``class_idx``, ``obs_mask`` and ``obs_depth`` are
    per image (leading B) and repeat over the hypotheses.  A challenger
    replaces hypothesis 0 only when it beats hypothesis 0's score by more
    than ``select_margin``: converged hypotheses tie within score noise,
    and an argmax among them would pick a slightly worse pose about half
    the time; a wrong basin loses by far more.  A hypothesis 0 that
    renders nothing (``-inf``) is replaced by any finite challenger.
    """
    b = obs_rgb.shape[0]
    nh = hyps.shape[0] // b
    obs_r = obs_rgb.repeat(nh, 1, 1, 1)
    k_r = k.repeat(nh, 1, 1)
    cls_r = class_idx.repeat(nh)
    depth_r = None if obs_depth is None else obs_depth.repeat(nh, 1, 1)
    refined = refine_poses(
        model, assets, obs_r, hyps, k_r, cls_r, num_iters=num_iters, out_size=out_size,
        obs_mask=None if obs_mask is None else obs_mask.repeat(nh, 1, 1),
        obs_depth=depth_r, coarse_iters=coarse_iters, coarse_size=coarse_size)
    scores = score_poses(gather_class(assets, cls_r), obs_r, refined, k_r, out_size,
                         obs_depth=depth_r).reshape(nh, b)
    refined = refined.reshape(nh, b, 3, 4)
    best = scores.argmax(0)
    best = torch.where(scores.amax(0) - scores[0] > select_margin, best, 0)
    return refined[best, torch.arange(b, device=best.device)], scores.T


def refine_multi_hypothesis(model, assets: RenderAssets, obs_rgb: torch.Tensor,
                            init_pose: torch.Tensor, k: torch.Tensor,
                            class_idx: torch.Tensor, generator: torch.Generator,
                            num_hypotheses: int = 4, num_iters: int = 4,
                            out_size: tuple[int, int] = (480, 640),
                            hyp_rot_deg: float = 20.0, hyp_trans: tuple = (0.02, 0.02, 0.08),
                            obs_mask: torch.Tensor | None = None,
                            obs_depth: torch.Tensor | None = None, coarse_iters: int = 0,
                            coarse_size: tuple[int, int] | None = None,
                            select_margin: float = 0.05) -> tuple[torch.Tensor, torch.Tensor]:
    """Refine ``num_hypotheses`` perturbations of each init, keep the best
    -> (best poses (B, 3, 4), scores (B, num_hypotheses)).

    Hypothesis 0 is the unperturbed init (:func:`draw_hypotheses`, from
    ``generator``); the rest is :func:`select_hypotheses`, with the same
    coarse-to-fine schedule as a single-hypothesis ``refine_poses``.
    """
    hyps = draw_hypotheses(generator, init_pose, num_hypotheses, hyp_rot_deg, hyp_trans)
    return select_hypotheses(model, assets, obs_rgb, hyps, k, class_idx, num_iters, out_size,
                             obs_mask, obs_depth, coarse_iters, coarse_size, select_margin)
