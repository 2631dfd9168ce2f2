"""Video tracking driver: ``python -m deepim_tpu_torch.cli.track --cfg <yaml>``.

Port of ``deepim_tpu/cli/track.py`` on one device: ``cuda:0`` unless
``--device`` names another (``--device cpu`` for the CPU); without CUDA it
raises rather than fall back.  Every object of each sequence is tracked by
propagating refined poses frame to frame
(:func:`~deepim_tpu_torch.refine.refine_video`), optionally with lost-track
recovery, and scored with the per-frame ADD(-S) and AUC tables of the YCB
protocol (``track_results.json``).

Frames stream from disk to the device one window (``--window``) at a time;
the pose carries across windows, and the frame-0 budget
(``--iters-first``) applies to frame 0 only, so windowed and whole runs
agree.  Recovery in window ``w0`` draws its re-seeds from a generator
seeded ``17 + w0``.  The kernels render on the card, their plain versions
on the CPU.

Without ``--video-root`` the sequences are generated
(:func:`~deepim_tpu_torch.data.video.gen_video`) into
``<output_dir>/<experiment>/video_data_<h>``, ``h`` the first 8 hex digits
of the SHA-256 of the generation parameters.  A directory is reused only
when its ``gen_params.json`` equals the parameters asked for; otherwise
it is generated afresh.  Nothing is deleted.  (The reference keys reuse
by a name built from some of the parameters, so a run could track stale
frames.)
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Video pose tracking eval")
    p.add_argument("--cfg", required=True)
    p.add_argument("--video-root", default="",
                   help="video dataset root (default: generate sequences)")
    p.add_argument("--num-frames", type=int, default=8)
    p.add_argument("--iters-first", type=int, default=4)
    p.add_argument("--iters-rest", type=int, default=2)
    p.add_argument("--objects-per-seq", type=int, default=1,
                   help="objects per generated sequence (1 = LM6d-style single-object "
                        "tracking; 0 = all, YCB-style)")
    p.add_argument("--window", type=int, default=64,
                   help="frames streamed to the device per tracking window; the pose "
                        "carries across windows")
    p.add_argument("--occluders", type=int, default=0,
                   help="generated sequences only: N untracked boxes sweeping in front "
                        "of the tracked objects")
    p.add_argument("--recover-threshold", type=float, default=None,
                   help="arm lost-track recovery below this score_poses value (try "
                        "-0.12)")
    p.add_argument("--recover-hypotheses", type=int, default=4)
    p.add_argument("--recover-iters", type=int, default=4)
    p.add_argument("--seed", type=int, default=-1,
                   help="track with a seed-variance training run's checkpoint: suffixes "
                        "the experiment dir with _seed<k> like cli.train --seed")
    p.add_argument("--results-out", default="",
                   help="also write the tracking results JSON, wrapped with argv and "
                        "git metadata, to this path")
    p.add_argument("--label-ids", choices=("slot", "global"), default="slot",
                   help="label.png pixel convention: 'slot' = 1 + the object's position "
                        "in the sequence's object list (what gen_video writes); 'global' "
                        "= dataset.obj_ids when configured, else class_idx + 1")
    p.add_argument("--device", default="cuda:0",
                   help="torch device to track on (default cuda:0; 'cpu' for the CPU)")
    return p.parse_args(argv)


def generated_root(out_dir: str, params: dict) -> str:
    """Where the sequences of ``params`` (a ``video_manifest``) are generated."""
    h = hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:8]
    return os.path.join(out_dir, f"video_data_{h}")


def main(argv=None) -> int:
    from deepim_tpu_torch.cli.train import _device, load_assets_and_names
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.data.video import (
        VideoDataset, gen_video, read_manifest, video_manifest)
    from deepim_tpu_torch.eval import evaluate_poses, format_table
    from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES
    from deepim_tpu_torch.refine import refine_video
    from deepim_tpu_torch.train.checkpoint import (
        checkpoint_dir, latest_step, load_params, orbax_dir, require_port_checkpoint,
        restore_checkpoint)
    from deepim_tpu_torch.train.train import make_model

    args = parse_args(argv)
    cfg = update_config(args.cfg)
    if args.seed >= 0:
        cfg = dataclasses.replace(cfg, experiment=f"{cfg.experiment}_seed{args.seed}")
    dev = _device(args.device)
    ckpt_dir = checkpoint_dir(cfg)
    require_port_checkpoint(ckpt_dir, orbax_dir(cfg))  # before any work
    out_dir = os.path.join(cfg.output_dir, cfg.experiment)
    os.makedirs(out_dir, exist_ok=True)
    d = cfg.dataset
    image_size = (d.image_height, d.image_width)
    out_size = (cfg.network.input_height, cfg.network.input_width)
    k_np = np.array([[d.fx, 0, d.cx], [0, d.fy, d.cy], [0, 0, 1]], np.float32)

    assets, names, symmetric = load_assets_and_names(cfg, eval_set=True, device=dev)
    model = make_model(cfg, len(d.objects), inference=True,
                       generator=torch.Generator().manual_seed(0)).to(dev).eval()
    if latest_step(ckpt_dir) is not None:
        step, params = restore_checkpoint(ckpt_dir, device=dev)
        load_params(model, params)
        print(f"loaded checkpoint step {step}")
    else:
        print("WARNING: no checkpoint — tracking with an untrained net")

    root = args.video_root
    if not root:
        wanted = video_manifest(names, k_np, image_size, args.num_frames,
                                objects_per_sequence=args.objects_per_seq or None,
                                occluders=args.occluders)
        root = generated_root(out_dir, wanted)
        if read_manifest(root) == wanted:
            print(f"reusing the generated video dataset under {root}")
        else:
            print(f"generating synthetic video dataset under {root}")
            gen_video(root, {n: PROCEDURAL_MESHES[n]() for n in names}, k_np, image_size,
                      num_frames=args.num_frames,
                      objects_per_sequence=args.objects_per_seq or None,
                      occluders=args.occluders, device=dev)
    ds = VideoDataset(root, names)

    # Depth feeds the network only for input_depth models, but also the
    # recovery score (the z resolution that the zoom denies to RGB).
    want_depth = bool(cfg.network.input_depth) or args.recover_threshold is not None
    k_t = torch.from_numpy(k_np).to(dev)
    all_est, all_gt, all_cls = [], [], []
    n_frames_all = load_s = refine_s = 0.0
    t_start = time.perf_counter()
    for seq in ds.sequences():
        n_frames = len(ds.frame_ids(seq))
        win = max(args.window, 1)
        cls = ks = carry_pose = None
        t_total = m = 0
        for w0 in range(0, n_frames, win):
            t0 = time.perf_counter()
            data = ds.load_sequence(seq, with_depths=want_depth,
                                    with_labels=cfg.network.input_mask, start=w0, count=win)
            frames = torch.from_numpy(data["frames"]).to(dev)  # (T, H, W, 3), shared
            if cls is None:
                cls = torch.from_numpy(data["class_idx"]).to(dev)
                ks = k_t.expand(cls.shape[0], 3, 3).contiguous()
            if carry_pose is None:
                init = ds.init_poses(seq)
                init = torch.from_numpy(init if init is not None else data["poses"][0]).to(dev)
            else:
                init = carry_pose
            obs_depths = None
            if want_depth:
                if data["depths"] is not None:
                    obs_depths = torch.from_numpy(data["depths"]).to(dev)  # shared
                elif w0 == 0 and cfg.network.input_depth:
                    print(f"WARNING: seq {seq} has no depth stream; the input_depth model "
                          "falls back to rendered depth")
            obs_masks = None
            if cfg.network.input_mask:
                if data["labels"] is not None:
                    lab = torch.from_numpy(data["labels"].astype(np.int64)).to(dev)
                    if args.label_ids == "global":
                        cls_np = data["class_idx"]
                        ids = (np.asarray(list(d.obj_ids), np.int64)[cls_np] if d.obj_ids
                               else cls_np.astype(np.int64) + 1)
                        ids = torch.from_numpy(ids).to(dev)
                    else:
                        ids = torch.arange(1, cls.shape[0] + 1, device=dev)
                    obs_masks = (lab[:, None] == ids[None, :, None, None]).to(torch.float32)
                    if w0 == 0 and not bool(obs_masks.any()):
                        print(f"WARNING: seq {seq}: the label stream matched no pixels under "
                              f"the '{args.label_ids}' id convention; check --label-ids")
                elif w0 == 0:
                    print(f"WARNING: seq {seq} has no label stream; the input_mask model "
                          "falls back to rendered masks")
            t1 = time.perf_counter()
            traj = refine_video(
                model, assets, frames, init, ks, cls,
                # the frame-0 budget on frame 0 only; later windows go on from
                # the carried pose
                iters_first=args.iters_first if w0 == 0 else args.iters_rest,
                iters_rest=args.iters_rest, out_size=out_size, obs_masks=obs_masks,
                obs_depths=obs_depths, recover_threshold=args.recover_threshold,
                recover_hypotheses=args.recover_hypotheses, recover_iters=args.recover_iters,
                generator=torch.Generator(device=dev).manual_seed(17 + w0))
            if args.recover_threshold is not None:
                traj, conf = traj
                n_low = int((conf < args.recover_threshold).sum())
                if n_low:
                    print(f"  seq {seq} window {w0}: {n_low} low-confidence frame-objects "
                          "(recovery armed)")
            carry_pose = traj[-1]
            t_w, m = traj.shape[0], traj.shape[1]
            all_est.append(traj.cpu().numpy().reshape(t_w * m, 3, 4))
            load_s += t1 - t0
            refine_s += time.perf_counter() - t1
            t_total += t_w
            all_gt.append(data["poses"].reshape(t_w * m, 3, 4))
            all_cls.append(np.tile(data["class_idx"], t_w))
        n_frames_all += t_total
        print(f"seq {seq}: tracked {m} objects over {t_total} frames "
              f"({-(-n_frames // win)} windows)")
    wall = time.perf_counter() - t_start
    print(f"tracked {int(n_frames_all)} frames in {wall:.2f}s ({n_frames_all / wall:.2f} "
          f"frames/s on {dev}; loading {load_s:.2f}s, refining {refine_s:.2f}s)")

    est = np.concatenate(all_est)
    gt = np.concatenate(all_gt)
    cls_all = np.concatenate(all_cls)
    ks_all = np.tile(k_np[None], (len(est), 1, 1))
    results = evaluate_poses(assets, names, symmetric, est, gt, cls_all, ks_all)
    print(format_table(results, f"{cfg.experiment} — video tracking (AUC = YCB protocol)"))
    with open(os.path.join(out_dir, "track_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    if args.results_out:
        from deepim_tpu_torch.utils.results import record_result

        record_result(args.results_out, results, experiment=cfg.experiment, argv=argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
