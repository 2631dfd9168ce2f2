"""Refinement success vs. init-pose error curves (reference protocol).

The DeepIM paper characterizes the refiner by sweeping the initial pose
error and plotting the post-refinement success rate (its ModelNet section
reports success-vs-init curves rather than one number).  This tool runs
that protocol on a trained checkpoint: for each init-noise level it
generates a fixed eval set, refines with K iterations (optionally
multi-hypothesis), and prints one table row per level with init vs
refined ADD(-S)@0.1d / (5°,5cm) / Proj2D.

Usage:
    python -m deepim_tpu_torch.tools.robustness_curve --cfg experiments/cfgs/foo.yaml \
        [--samples 256] [--hypotheses 1] \
        [--rot-levels 5,15,30,45,60] [--trans-scale 0.02] [--device cuda:0]

``--trans-scale`` sets the translation noise std (meters, all axes) at
the 15° level; other levels scale it proportionally to rot/15 so both
error sources grow together (the paper's sweep couples them the same
way).  Port of ``tools/robustness_curve.py``: its arguments and table;
batch ``i`` of a level is :func:`~deepim_tpu_torch.data.synthetic_batch`
from a ``torch.Generator`` on the device seeded ``31000 + i``, its
hypotheses from one seeded ``77 + i``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="success-vs-init-error robustness curves")
    p.add_argument("--cfg", required=True)
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--hypotheses", type=int, default=1)
    p.add_argument("--rot-levels", default="5,15,30,45,60",
                   help="comma list of init rotation noise stds (deg)")
    p.add_argument("--trans-scale", type=float, default=0.02,
                   help="translation noise std (m) at the 15deg level")
    p.add_argument("--device", default="cuda:0",
                   help="torch device (default cuda:0; 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from deepim_tpu_torch.cli.train import _device, load_assets_and_names
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.data.synthetic import synthetic_batch
    from deepim_tpu_torch.eval import evaluate_poses
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.refine import refine_multi_hypothesis, refine_poses
    from deepim_tpu_torch.tools import restored_model

    cfg = update_config(args.cfg)
    dev = _device(args.device)
    assets, names, symmetric = load_assets_and_names(cfg, eval_set=True, device=dev)
    model, _ = restored_model(cfg, len(cfg.dataset.objects), dev)

    d = cfg.dataset
    k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
    image_size = (d.image_height, d.image_width)
    out_size = (cfg.network.input_height, cfg.network.input_width)
    bs = cfg.test.batch_size
    n = max(bs, (args.samples // bs) * bs)
    levels = [float(x) for x in args.rot_levels.split(",")]
    ks = k_cam.expand(bs, 3, 3).contiguous()

    header = (f"{'rot_std':>8} {'trans_std':>10} {'init_add':>9} "
              f"{'add(-s)':>8} {'5d5cm':>7} {'proj2d':>7} {'auc':>6}")
    print(header)
    print("-" * len(header))
    for rot in levels:
        tr = args.trans_scale * rot / 15.0
        est_all, init_all, gt_all, cls_all = [], [], [], []
        for i in range(n // bs):
            batch = synthetic_batch(
                torch.Generator(device=dev).manual_seed(31000 + i), assets, bs, k_cam,
                image_size, rot_noise_deg=rot, rot_max_deg=3 * rot,
                trans_noise=(tr,) * 3, trans_max=(3 * tr,) * 3)
            with torch.no_grad():
                if args.hypotheses > 1:
                    est, _ = refine_multi_hypothesis(
                        model, assets, batch["obs_rgb"], batch["pose_src"], ks,
                        batch["class_idx"], torch.Generator(device=dev).manual_seed(77 + i),
                        num_hypotheses=args.hypotheses, num_iters=cfg.test.test_iter,
                        out_size=out_size, obs_depth=batch.get("obs_depth"),
                        obs_mask=batch.get("obs_mask"), coarse_iters=cfg.test.coarse_iters)
                else:
                    est = refine_poses(
                        model, assets, batch["obs_rgb"], batch["pose_src"], ks,
                        batch["class_idx"], num_iters=cfg.test.test_iter, out_size=out_size,
                        coarse_iters=cfg.test.coarse_iters, obs_depth=batch.get("obs_depth"),
                        obs_mask=batch.get("obs_mask"))
            est_all.append(est)
            init_all.append(batch["pose_src"])
            gt_all.append(batch["pose_tgt"])
            cls_all.append(batch["class_idx"])
        est, init, gt, cls = (torch.cat(x).cpu().numpy()
                              for x in (est_all, init_all, gt_all, cls_all))
        ks_np = np.tile(k_cam.cpu().numpy()[None], (est.shape[0], 1, 1))
        t_init = evaluate_poses(assets, names, symmetric, init, gt, cls, ks_np)
        t_ref = evaluate_poses(assets, names, symmetric, est, gt, cls, ks_np)
        m, mi = t_ref["mean"], t_init["mean"]
        print(f"{rot:8.1f} {tr:10.3f} {mi['add(-s)_0.1d']:9.2f} "
              f"{m['add(-s)_0.1d']:8.2f} {m['5deg_5cm']:7.2f} "
              f"{m['proj2d_5px']:7.2f} {m['auc_add(-s)']:6.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
