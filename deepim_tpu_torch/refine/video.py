"""Video pose propagation: refine through a frame sequence (torch).

Port of ``deepim_tpu/refine/video.py``.  Frame t's refined pose
initializes frame t+1.  The reference scans over frames in one compiled
program; here frames and iterations are Python loops over batched
``refine_step`` calls.

Plain propagation loses a track for good once an occluder or a motion
spike pushes the pose out of the refiner's basin.  ``recover_threshold``
arms re-acquisition: the render-vs-observed score
(:func:`~deepim_tpu_torch.refine.hypotheses.score_poses`) monitors each
track, and a frame where any track scores below the threshold refines a
fan of perturbed re-seeds around those tracks and keeps the best
(:func:`reacquire`).  The reference gates that work with a batch-level
``lax.cond``; here it is a host branch on ``lost.any()``, one
device-to-host sync per frame.
"""

from __future__ import annotations

import torch

from deepim_tpu_torch.data.pairs import perturb_poses
from deepim_tpu_torch.ops.zoom import ZoomBox, compute_zoom_box
from deepim_tpu_torch.refine.hypotheses import score_poses
from deepim_tpu_torch.refine.refiner import RenderAssets, gather_class, refine_step


def draw_reseeds(generator: torch.Generator, pose: torch.Tensor, num_hypotheses: int,
                 rot_deg: float = 20.0, trans: tuple = (0.04, 0.04, 0.04)) -> torch.Tensor:
    """(num_hypotheses*B, 3, 4) candidates, hypothesis-major: ``pose`` (B, 3,
    4) itself, then ``num_hypotheses - 1`` perturbations of it (gaussian,
    clipped at three standard deviations)."""
    pert = perturb_poses(generator, pose.repeat(num_hypotheses - 1, 1, 1),
                         rot_std_deg=rot_deg, rot_max_deg=3.0 * rot_deg, trans_std=trans,
                         trans_max=tuple(3.0 * t for t in trans))
    return torch.cat([pose, pert])


@torch.no_grad()
def reacquire(model, assets: RenderAssets, cand: torch.Tensor, frame: torch.Tensor,
              k: torch.Tensor, class_idx: torch.Tensor, out_size: tuple[int, int],
              mask: torch.Tensor | None = None, depth: torch.Tensor | None = None,
              iters: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Refine the hypothesis-major candidates ``cand`` (N*B, 3, 4), whose
    first B rows are the incumbents, and keep each track's best scorer ->
    (poses (B, 3, 4), scores (B,)).

    ``frame`` (B, H, W, 3), ``k``, ``class_idx``, ``mask`` and ``depth``
    are per track and repeat over the candidates (a broadcast ``frame`` or
    ``depth`` stays one).  Candidates are ranked in the incumbent's zoom
    window: each candidate's own would favour nearer re-seeds.
    """
    b = k.shape[0]
    nh = cand.shape[0] // b

    def tile(x):
        if x is None:
            return None
        if x.stride(0) == 0:  # one image shared by every track
            return x[:1].expand(nh * b, *x.shape[1:])
        return x.repeat(nh, *([1] * (x.dim() - 1)))

    cls_h = class_idx.repeat(nh)
    assets_h = gather_class(assets, cls_h)
    k_h, frame_h, mask_h, depth_h = tile(k), tile(frame), tile(mask), tile(depth)
    box = compute_zoom_box(cand[:b], k, assets_h.corners[:b], out_size)
    for _ in range(iters):
        cand = refine_step(model, assets_h, frame_h, cand, k_h, cls_h, out_size,
                           obs_mask=mask_h, obs_depth=depth_h).pose
    sc = score_poses(assets_h, frame_h, cand, k_h, out_size, obs_depth=depth_h,
                     box=ZoomBox(*(v.repeat(nh) for v in box))).reshape(nh, b)
    best = sc.argmax(0)
    return cand.reshape(nh, b, 3, 4)[best, torch.arange(b, device=best.device)], sc.amax(0)


@torch.no_grad()
def refine_video(model, assets: RenderAssets, frames: torch.Tensor,
                 init_pose: torch.Tensor, k: torch.Tensor, class_idx: torch.Tensor,
                 iters_first: int = 4, iters_rest: int = 2,
                 out_size: tuple[int, int] = (480, 640),
                 obs_masks: torch.Tensor | None = None,
                 obs_depths: torch.Tensor | None = None,
                 recover_threshold: float | None = None, recover_hypotheses: int = 4,
                 recover_iters: int = 4, recover_rot_deg: float = 20.0,
                 recover_trans: tuple = (0.04, 0.04, 0.04), recover_margin: float = 0.05,
                 generator: torch.Generator | None = None):
    """Track B objects through T frames -> refined poses (T, B, 3, 4).

    ``iters_first`` iterations on frame 0 (large init error), then
    ``iters_rest`` on each later frame (small frame-to-frame motion).
    ``frames`` is (T, B, H, W, 3), or (T, H, W, 3) for one stream that all
    B objects share, which is broadcast, never copied B-fold; the same
    holds for ``obs_depths`` (T, B, H, W) or (T, H, W).  ``obs_masks``
    (T, B, H, W) are per object.

    With ``recover_threshold`` (a ``score_poses`` value) the result is
    ``(poses (T, B, 3, 4), scores (T, B))``: after each frame's refinement
    every track is scored, and if any falls below the threshold,
    ``recover_hypotheses`` candidates around each track (the track itself
    first, re-seeds drawn from ``generator``) are refined
    ``recover_iters`` times; a lost track takes its best candidate only if
    that beats its score by more than ``recover_margin`` (re-seeds that
    are symmetry-equivalent to the incumbent tie with it and must not
    scramble the propagated pose).
    """
    assets_b = gather_class(assets, class_idx)
    b = init_pose.shape[0]
    shared_frames = frames.dim() == 4
    shared_depths = obs_depths is not None and obs_depths.dim() == 3
    if recover_threshold is not None and generator is None:
        generator = torch.Generator(device=init_pose.device).manual_seed(0)

    def inputs(t):
        frame = frames[t].expand(b, *frames.shape[1:]) if shared_frames else frames[t]
        mask = None if obs_masks is None else obs_masks[t]
        depth = None if obs_depths is None else obs_depths[t]
        if shared_depths:
            depth = depth.expand(b, *depth.shape)
        return frame, mask, depth

    def refine_n(pose, frame, mask, depth, n):
        for _ in range(n):
            pose = refine_step(model, assets_b, frame, pose, k, class_idx, out_size,
                               obs_mask=mask, obs_depth=depth).pose
        return pose

    def monitor(pose, frame, mask, depth):
        sc = score_poses(assets_b, frame, pose, k, out_size, obs_depth=depth)
        lost = sc < recover_threshold
        if not bool(lost.any()):  # the host branch: one sync per frame
            return pose, sc
        cand = draw_reseeds(generator, pose, recover_hypotheses, recover_rot_deg,
                            recover_trans)
        pose_r, sc_r = reacquire(model, assets, cand, frame, k, class_idx, out_size,
                                 mask, depth, recover_iters)
        take = lost & (sc_r > sc + recover_margin)
        return torch.where(take[:, None, None], pose_r, pose), torch.where(take, sc_r, sc)

    poses, scores = [], []
    pose = init_pose
    for t in range(frames.shape[0]):
        frame, mask, depth = inputs(t)
        pose = refine_n(pose, frame, mask, depth, iters_first if t == 0 else iters_rest)
        if recover_threshold is not None:
            pose, sc = monitor(pose, frame, mask, depth)
            scores.append(sc)
        poses.append(pose)
    traj = torch.stack(poses)
    return traj if recover_threshold is None else (traj, torch.stack(scores))
