"""Testing driver: ``python -m deepim_tpu_torch.cli.test --cfg <yaml>``.

Port of ``deepim_tpu/cli/test.py`` on one device: ``cuda:0`` unless
``--device`` names another (``--device cpu`` for the CPU); without CUDA it
raises rather than fall back.  It restores the experiment's port
checkpoint, runs the K-iteration refinement (or, with ``--hypotheses``,
multi-hypothesis refinement and selection) over the test set, prints the
reference's per-iteration lines and ADD(-S)/(5°, 5 cm)/Proj-2D table, and
writes ``eval_results.json``, with ``--save-poses`` ``refined_poses.npz``
and ``bop_results.csv``, with ``--vis`` overlay montages under ``vis/``.

Generated test sets are drawn on the device: ``synthetic*`` and
``modelnet`` batch ``i`` is :func:`~deepim_tpu_torch.data.synthetic_batch`
from a ``torch.Generator`` seeded ``9000 + i``, ``synthetic_occlusion``
batch ``i`` :func:`~deepim_tpu_torch.data.synthetic_occlusion_batch` from
one seeded ``1000 + i``.  These are the port's own fixed protocol sets:
torch generators draw other numbers than the reference's JAX keys, so a
port table and a reference table are never computed on the same draws
(and a card's draws differ from the CPU's).

On-disk test sets stream from ``dataset.root``: ``lm6d*`` (and any other
name) the LM6d layout's ``test`` split of every object, ``ycb_video`` the
keyframe protocol (every object of a sequence on each keyframe of
``video_sets/keyframe.txt``).  Frames decode on a thread pool one batch
ahead (``prefetch_iter``), stack into pinned host slots and convert on the
device.  Init poses: ``test.init: posecnn`` takes ``init_poses/`` (LM6d;
GT where there are none), ``perturb`` perturbs GT with a CPU generator
seeded 7; ``--init-poses`` (a BOP CSV) and ``--posecnn-mat`` (ycb_video)
then overwrite the records they match.  The last batch is padded with the
last record; padded rows are left out of the tables and the files, and the
BOP CSV carries the records' scene and image ids (placeholders, jointly,
when a name is not numeric).

``--quant int8`` evaluates the dynamic int8 model; ``--quant int8_static``
first calibrates static activation scales (``models/quant.py
§calibrate_model``, estimator ``--quant-calib``, default ``max_c``) on the
first two batches of the test stream, which then go back into the stream
so every sample is still scored.

Data-parallel evaluation (the reference's data-mesh branch): with more
than one rank (``--n-devices``, or ``torchrun``; ``parallel.launch``) whose
count divides the test batch, every rank draws or loads the whole batch,
as one process does (so the eval set is the single-device one), refines
its contiguous rows, and the rows come back to every rank through one
all-reduce of a zero-filled buffer of the whole set (exact, and on gloo
with CUDA tensors, which have no ``all_gather``).  Rank 0 evaluates and
writes the tables and files; the others write nothing.  With
``--hypotheses``, every rank draws the whole batch's hypotheses from one
process's seed and keeps its rows', so the answer is one process's.  A
world that does not divide the batch refines every row on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a deepim_tpu_torch model")
    p.add_argument("--cfg", required=True)
    p.add_argument("--num-samples", type=int, default=0,
                   help="generated eval set size (0 = max(2048, 8*batch), so the "
                        "tables' CIs resolve few-point deltas)")
    p.add_argument("--no-refine", action="store_true",
                   help="evaluate the init poses only (baseline row)")
    p.add_argument("--hypotheses", type=int, default=1,
                   help=">1: multi-hypothesis refinement with render-agreement "
                        "selection (occlusion protocol)")
    p.add_argument("--coarse-iters", type=int, default=-1,
                   help="override cfg.test.coarse_iters (-1 = the config's)")
    p.add_argument("--vis", type=int, default=0,
                   help="write rendered-vs-observed overlay montages (INIT, each "
                        "iteration, GT) for the first N samples")
    p.add_argument("--init-poses", default="",
                   help="BOP results CSV of external init poses, matched to the on-disk "
                        "test records by (scene_id, im_id, obj_id); unmatched records "
                        "keep their default init")
    p.add_argument("--posecnn-mat", default="",
                   help="directory of PoseCNN's per-keyframe .mat results ({i:06d}.mat in "
                        "keyframe.txt order) used as init poses (dataset.name=ycb_video)")
    p.add_argument("--init-rot-noise", type=float, default=-1.0,
                   help="override the init rotation noise std (degrees; max = 3x std)")
    p.add_argument("--init-trans-noise", type=float, default=-1.0,
                   help="override the init translation noise std (metres, all axes; "
                        "max = 3x std)")
    p.add_argument("--quant-calib", default="max_c",
                   help="int8_static calibration estimator: max | p999 (99.9%% clip) | "
                        "max_c / p999_c (per channel, folded into the weights); see "
                        "models/quant.py")
    p.add_argument("--quant", default="", choices=("", "none", "int8", "int8_static"),
                   help="override cfg.network.quant for this eval: int8 runs the encoder "
                        "and fc1/fc2 in int8 on the same checkpoint, int8_static first "
                        "calibrates static activation scales on the first two batches")
    p.add_argument("--seed", type=int, default=-1,
                   help="evaluate a seed-variance training run: suffixes the experiment "
                        "dir with _seed<k> like cli.train --seed (the eval set stays the "
                        "fixed one)")
    p.add_argument("--results-out", default="",
                   help="also write the eval results JSON, wrapped with argv and git "
                        "metadata, to this path")
    p.add_argument("--save-poses", action="store_true",
                   help="write refined_poses.npz (per-iteration trajectories) and "
                        "bop_results.csv (final poses)")
    p.add_argument("--device", default="cuda:0",
                   help="torch device to evaluate on (default cuda:0; 'cpu' for the CPU)")
    p.add_argument("--n-devices", type=int, default=0,
                   help="data-parallel ranks, one process each (0 = every visible card; "
                        "with --device cpu, that many CPU ranks; under torchrun the "
                        "environment's world)")
    return p.parse_args(argv)


def generated(name: str) -> bool:
    """Whether ``dataset.name`` is a set the package generates itself."""
    return name.startswith("synthetic") or name == "modelnet"


def eval_stream(cfg, assets, k_cam: torch.Tensor, num_batches: int, batch_size: int):
    """The generated test set, batch by batch, on the assets' device."""
    from deepim_tpu_torch.data.synthetic import synthetic_batch, synthetic_occlusion_batch

    d, t = cfg.dataset, cfg.train
    occlusion = d.name == "synthetic_occlusion"
    draw, base = ((synthetic_occlusion_batch, 1000) if occlusion
                  else (synthetic_batch, 9000))
    dev = assets.points.device
    for i in range(num_batches):
        yield draw(torch.Generator(device=dev).manual_seed(base + i), assets, batch_size,
                   k_cam, (d.image_height, d.image_width), rot_noise_deg=t.rot_noise_deg,
                   rot_max_deg=t.rot_noise_max_deg, trans_noise=tuple(t.trans_noise),
                   trans_max=tuple(t.trans_noise_max))


@torch.no_grad()
def refine_batches(model, assets, batches, k_cam: torch.Tensor, num_iters: int,
                   out_size: tuple[int, int], coarse_iters: int = 0,
                   coarse_size: tuple[int, int] | None = None, hypotheses: int = 1,
                   no_refine: bool = False, want_depth: bool = False,
                   with_mask: bool = False, vis: int = 0,
                   rank_rows: tuple[int, int] = (0, 1)) -> dict:
    """The eval loop: refine every batch of ``batches`` (dicts with
    ``obs_rgb``, ``pose_src``, ``pose_tgt``, ``class_idx`` and, as the
    model and ``want_depth`` need them, ``obs_mask`` and ``obs_depth``),
    moved to the assets' device by
    :func:`~deepim_tpu_torch.data.lm6d.to_device` (non-blocking copies; a
    loader's uint8 and uint16 frames converted there).

    Returns ``traj`` ((num_iters + 1, n, 3, 4) on the device, the inits
    first; (2, n, 3, 4) with ``no_refine`` or ``hypotheses`` > 1),
    ``pose_gt`` and ``class_idx`` (numpy) and ``vis_rows``, the first
    ``vis`` observed frames (numpy).  Batch ``bi`` of ``bs`` rows draws its
    hypotheses from a generator seeded ``17 + bi*bs``.  With ``rank_rows``
    = (i, n), data rank ``i`` of ``n`` refines and returns its contiguous
    ``bs/n`` rows of each whole batch; the hypotheses are drawn for the
    whole batch first, so every row gets one process's draws.
    """
    from deepim_tpu_torch.data.lm6d import to_device
    from deepim_tpu_torch.refine import draw_hypotheses, refine_poses, select_hypotheses

    dev = assets.points.device
    i, n = rank_rows
    trajs, gt_parts, cls_parts, vis_rows = [], [], [], []
    for bi, host in enumerate(batches):
        batch = to_device(host, dev)
        bs = batch["obs_rgb"].shape[0]
        if vis and len(vis_rows) < vis:
            vis_rows += list(batch["obs_rgb"][:vis - len(vis_rows)].cpu().numpy())
        multi = hypotheses > 1 and not no_refine
        if multi:  # (hypotheses, bs, 3, 4), hypothesis-major as refine_multi_hypothesis draws
            hyps = draw_hypotheses(torch.Generator(device=dev).manual_seed(17 + bi * bs),
                                   batch["pose_src"], hypotheses).view(hypotheses, bs, 3, 4)
        rows = slice(i * bs // n, (i + 1) * bs // n)
        batch = {key: v[rows] if isinstance(v, torch.Tensor) else v for key, v in batch.items()}
        obs, init, cls = batch["obs_rgb"], batch["pose_src"], batch["class_idx"]
        ks = k_cam.to(dev).expand(obs.shape[0], 3, 3).contiguous()
        obs_mask = batch["obs_mask"] if with_mask else None
        obs_depth = batch.get("obs_depth") if want_depth else None
        gt_parts.append(batch["pose_tgt"])
        cls_parts.append(batch["class_idx"])
        if no_refine:
            trajs.append(init[None].expand(2, *init.shape))
        elif multi:  # refine_multi_hypothesis on this rank's rows of the draws
            best, _ = select_hypotheses(model, assets, obs, hyps[:, rows].reshape(-1, 3, 4), ks,
                                        cls, num_iters, out_size, obs_mask, obs_depth,
                                        coarse_iters, coarse_size)
            trajs.append(torch.stack([init, best]))
        else:
            trajs.append(refine_poses(
                model, assets, obs, init, ks, cls, num_iters=num_iters, out_size=out_size,
                return_all=True, obs_mask=obs_mask, obs_depth=obs_depth,
                coarse_iters=coarse_iters, coarse_size=coarse_size))
    # read back once, after the last batch: no host sync between batches
    return {"traj": torch.cat(trajs, dim=1), "pose_gt": torch.cat(gt_parts).cpu().numpy(),
            "class_idx": torch.cat(cls_parts).cpu().numpy(), "vis_rows": vis_rows}


def calibrated(model, assets, batches, k_cam: torch.Tensor, out_size: tuple[int, int],
               num_iters: int, mode: str):
    """The int8_static model calibrated on the first two of ``batches``
    (moved to the assets' device, since a loader reuses its host slots),
    and the stream with those two put back in front."""
    import itertools

    from deepim_tpu_torch.data.lm6d import to_device
    from deepim_tpu_torch.models.quant import calibrate_model

    dev = assets.points.device
    batches = iter(batches)
    calib = [to_device(b, dev) for b in itertools.islice(batches, 2)]
    model = calibrate_model(model, assets, calib, k_cam.to(dev), out_size,
                            num_iters=num_iters, mode=mode)
    print(f"int8_static: calibrated activation scales on {len(calib)} batches "
          f"(mode={mode})")
    return model, itertools.chain(calib, batches)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def write_vis(assets, vis_dir: str, obs: list[np.ndarray], traj: torch.Tensor,
              pose_gt: np.ndarray, class_idx: np.ndarray, ks: np.ndarray,
              image_size: tuple[int, int]) -> int:
    """One montage per sample of the overlays of INIT, each iteration and
    GT (``render_scene`` of the sample's object over its observed frame)
    -> how many were written."""
    from deepim_tpu_torch.refine import render_scene
    from deepim_tpu_torch.utils.viz import overlay_render, save_image, side_by_side

    dev = assets.points.device
    os.makedirs(vis_dir, exist_ok=True)
    nv = len(obs)
    cls = torch.from_numpy(class_idx[:nv, None]).to(dev)
    valid = torch.ones((nv, 1), dtype=torch.bool, device=dev)
    k_t = torch.from_numpy(ks[:nv]).to(dev)
    cols = []
    for pose in list(traj[:, :nv]) + [torch.from_numpy(pose_gt[:nv]).to(dev)]:
        rgb, depth = render_scene(assets, cls, pose[:, None], valid, k_t, image_size)
        cols.append((rgb.cpu().numpy(), depth.cpu().numpy()))
    for i in range(nv):
        tiles = [overlay_render(obs[i], rgb[i], depth[i]) for rgb, depth in cols]
        save_image(os.path.join(vis_dir, f"sample{i:03d}.png"), side_by_side(*tiles))
    return nv


def disk_test_set(cfg, args, batch_size: int, want_depth: bool, with_mask: bool,
                  pin_memory: bool):
    """The on-disk test set -> (records, batches, number of rows incl.
    padding).  ``batches`` yields the loader's host batches, with
    ``pose_src``, ``pose_tgt`` and ``class_idx`` in the same (pinned) slot;
    decoding runs one batch ahead on a background thread."""
    from deepim_tpu_torch.data.lm6d import (
        LM6DDataset, apply_bop_init, iter_frame_batches, prefetch_iter)
    from deepim_tpu_torch.data.pairs import perturb_poses

    d, t = cfg.dataset, cfg.train
    if d.name == "ycb_video":
        from deepim_tpu_torch.data.video import (
            VideoDataset, apply_posecnn_mat_init, iter_keyframe_batches, keyframe_records)

        ds = VideoDataset(d.root, list(d.objects))
        if not ds.has_keyframes():
            raise SystemExit(f"dataset.name=ycb_video needs {d.root}/video_sets/keyframe.txt "
                             "(the keyframe test list); for tracking use cli.track")
        records = keyframe_records(ds)
        frames = iter_keyframe_batches
    else:
        ds = LM6DDataset(d.root, list(d.objects))
        records = [r for obj in d.objects for r in ds.gt_roidb(obj, "test")]
        frames = iter_frame_batches
    if not records:
        raise SystemExit(f"no test records under {d.root}")
    n = (len(records) + batch_size - 1) // batch_size * batch_size
    padded = records + [records[-1]] * (n - len(records))
    pose_gt = np.stack([r.pose for r in padded])
    init = np.stack([r.pose if r.init_pose is None else r.init_pose for r in padded])
    if cfg.test.init == "perturb":
        init = perturb_poses(torch.Generator().manual_seed(7), torch.from_numpy(pose_gt),
                             t.rot_noise_deg, t.rot_noise_max_deg, tuple(t.trans_noise),
                             tuple(t.trans_noise_max)).numpy()
    obj_ids = list(d.obj_ids) or None
    if args.posecnn_mat:
        if d.name != "ycb_video":
            raise SystemExit("--posecnn-mat needs dataset.name=ycb_video")
        matched = apply_posecnn_mat_init(records, init, args.posecnn_mat, obj_ids=obj_ids)
        print(f"PoseCNN .mat init poses: matched {matched}/{len(records)} records from "
              f"{args.posecnn_mat}")
    if args.init_poses:
        matched = apply_bop_init(records, init, args.init_poses, obj_ids=obj_ids)
        print(f"external init poses: matched {matched}/{len(records)} records from "
              f"{args.init_poses}")
    extra = {"pose_src": init.astype(np.float32), "pose_tgt": pose_gt,
             "class_idx": np.asarray([r.class_idx for r in padded], np.int64)}
    drop = [k for k, keep in (("obs_depth", want_depth), ("obs_mask", with_mask)) if not keep]

    def batches():
        for fr in frames(ds, records, batch_size, pad_to=n, pin_memory=pin_memory, extra=extra):
            for k in drop:
                del fr[k]
            yield fr

    return records, prefetch_iter(batches()), n


def bop_ids(records) -> tuple[np.ndarray | None, np.ndarray | None]:
    """The records' (scene ids, image ids) as integers, or (None, None),
    jointly, when a name is not numeric: real scene ids beside made-up
    image ids would score against the wrong ground truths."""
    try:
        return (np.asarray([int(r.scene) for r in records], np.int64),
                np.asarray([int(r.frame) for r in records], np.int64))
    except ValueError:
        return None, None


def gather_eval(out: dict, mesh, n: int, bs: int) -> dict:
    """The whole set's ``traj``, ``pose_gt`` and ``class_idx`` on every rank
    from each rank's rows of every batch of ``bs`` (``parallel.gather_rows``)."""
    from deepim_tpu_torch.parallel.mesh import DATA_AXIS, gather_rows

    traj = out["traj"]
    k = bs // mesh.shape[DATA_AXIS]
    idx = (torch.arange(n // bs)[:, None] * bs + mesh.data_index * k
           + torch.arange(k)[None]).reshape(-1)
    full = gather_rows(traj.transpose(0, 1).contiguous(), idx, n, mesh).transpose(0, 1)
    gt = gather_rows(torch.from_numpy(out["pose_gt"]).to(traj.device), idx, n, mesh)
    cls = gather_rows(torch.from_numpy(out["class_idx"]).to(traj.device), idx, n, mesh)
    return {**out, "traj": full, "pose_gt": gt.cpu().numpy(), "class_idx": cls.cpu().numpy()}


def main(argv=None) -> int:
    from deepim_tpu_torch.parallel import launch

    args = parse_args(argv)
    return launch(evaluate, args.n_devices, args.device, args, argv)


def evaluate(dev: torch.device, args, argv=None) -> int:
    """The evaluation of ``args`` on this rank (``dev``) -> 0."""
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.eval import evaluate_poses, format_table, write_bop_csv
    from deepim_tpu_torch.models.quant import CALIB_MODES
    from deepim_tpu_torch.parallel import distributed, make_mesh, replicate
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.train.checkpoint import (
        checkpoint_dir, latest_step, load_params, orbax_dir, require_port_checkpoint,
        restore_checkpoint)
    from deepim_tpu_torch.train.train import make_model

    cfg = update_config(args.cfg)
    if args.seed >= 0:
        cfg = dataclasses.replace(cfg, experiment=f"{cfg.experiment}_seed{args.seed}")
    if args.quant:
        cfg = dataclasses.replace(cfg, network=dataclasses.replace(cfg.network,
                                                                   quant=args.quant))
    d, t = cfg.dataset, cfg.train
    if cfg.network.quant == "int8_static" and args.quant_calib not in CALIB_MODES:
        raise SystemExit(f"--quant-calib {args.quant_calib!r} is not one of {CALIB_MODES}")
    if d.obj_ids and len(d.obj_ids) != len(d.objects):
        # before any batch: --save-poses maps class indices through obj_ids
        raise SystemExit(f"dataset.obj_ids ({len(d.obj_ids)} entries) must be parallel "
                         f"to dataset.objects ({len(d.objects)})")
    if generated(d.name) and (args.init_poses or args.posecnn_mat):
        raise SystemExit("--init-poses/--posecnn-mat need an on-disk dataset; got "
                         f"dataset.name={d.name!r}, whose generated frames have no "
                         "(scene, im, obj) ids to match")
    if args.init_rot_noise >= 0:
        t = dataclasses.replace(t, rot_noise_deg=args.init_rot_noise,
                                rot_noise_max_deg=3.0 * args.init_rot_noise)
    if args.init_trans_noise >= 0:
        t = dataclasses.replace(t, trans_noise=(args.init_trans_noise,) * 3,
                                trans_noise_max=(3.0 * args.init_trans_noise,) * 3)
    cfg = dataclasses.replace(cfg, train=t)
    world = distributed.world_size()
    mesh = make_mesh(n_data=world) if world > 1 else None
    lead = distributed.rank() == 0
    say = print if lead else (lambda *a, **k: None)
    ckpt_dir = checkpoint_dir(cfg)
    require_port_checkpoint(ckpt_dir, orbax_dir(cfg))  # before any work
    out_dir = os.path.join(cfg.output_dir, cfg.experiment)
    os.makedirs(out_dir, exist_ok=True)

    assets, names, symmetric = load_assets_and_names(cfg, eval_set=True, device=dev)
    # Class-aware heads are sized by the training class set.
    train_classes = d.zoo_size if d.name == "modelnet" else len(d.objects)
    model = make_model(cfg, train_classes, inference=True,
                       generator=torch.Generator().manual_seed(0)).to(dev).eval()
    if latest_step(ckpt_dir) is not None:
        step, params = restore_checkpoint(ckpt_dir, device=dev)
        load_params(model, params)
        say(f"loaded checkpoint step {step}")
    else:
        say("WARNING: no checkpoint found — evaluating an untrained net (identity deltas)")
    if mesh is not None:
        replicate(mesh, model)  # rank 0's parameters on every rank

    image_size = (d.image_height, d.image_width)
    n_cfg = cfg.network
    out_size = (n_cfg.input_height, n_cfg.input_width)
    coarse_size = (n_cfg.coarse_height, n_cfg.coarse_width) if n_cfg.coarse_height else None
    coarse_iters = cfg.test.coarse_iters if args.coarse_iters < 0 else args.coarse_iters
    k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
    bs = cfg.test.batch_size
    want_depth = bool(n_cfg.input_depth) or args.hypotheses > 1
    records = None
    if generated(d.name):
        n = args.num_samples or max(2048, 8 * bs)
        n = num_real = (n // bs) * bs
        batches = eval_stream(cfg, assets, k_cam, n // bs, bs)
        source = "synthesis included"
    else:
        records, batches, n = disk_test_set(cfg, args, bs, want_depth, bool(n_cfg.input_mask),
                                            pin_memory=dev.type == "cuda")
        num_real = len(records)
        source = "PNG loading included"
    if cfg.network.quant == "int8_static" and not args.no_refine:
        model, batches = calibrated(model, assets, batches, k_cam, out_size,
                                    cfg.test.test_iter, args.quant_calib)
    dp = mesh is not None and bs % world == 0
    if dp:
        say(distributed.describe(dev))
        say(f"eval data-parallel over {world} ranks ({bs // world} rows of each batch of "
            f"{bs} a rank)")
    elif mesh is not None:
        say(f"batch {bs} does not divide {world} ranks: every rank refines every row")
    _sync(dev)
    t0 = time.time()
    out = refine_batches(
        model, assets, batches, k_cam, cfg.test.test_iter, out_size,
        coarse_iters=coarse_iters, coarse_size=coarse_size, hypotheses=args.hypotheses,
        no_refine=args.no_refine, want_depth=want_depth, with_mask=bool(n_cfg.input_mask),
        vis=args.vis, rank_rows=(mesh.data_index, world) if dp else (0, 1))
    if dp:
        out = gather_eval(out, mesh, n, bs)
    traj = out["traj"]
    _sync(dev)
    dt = time.time() - t0
    if not lead:
        return 0
    print(f"refined {n} hypotheses x {cfg.test.test_iter} iters in {dt:.2f}s "
          f"({n / dt:.1f} poses/s on {dev}{f' and {world - 1} more ranks' if dp else ''}, "
          f"{source})")
    n_refined = n

    # Padded rows (the last record repeated) are scored and exported by
    # no one.
    traj = traj[:, :num_real]
    pose_gt, class_idx = out["pose_gt"][:num_real], out["class_idx"][:num_real]
    n = num_real
    ks = np.tile(k_cam.cpu().numpy()[None], (n, 1, 1))
    traj_np = traj.cpu().numpy()
    t1 = time.time()
    results = None
    for it in range(traj_np.shape[0]):  # per-iteration rows, as the reference's pred_eval
        results = evaluate_poses(assets, names, symmetric, traj_np[it], pose_gt, class_idx, ks)
        label = "INIT" if it == 0 else f"iter {it}"
        print(f"[{label}] ADD(-S)@0.1d={results['mean']['add(-s)_0.1d']:.2f} "
              f"5d5cm={results['mean']['5deg_5cm']:.2f} "
              f"proj2d={results['mean']['proj2d_5px']:.2f}")
    print(f"evaluated {traj_np.shape[0]} x {n} poses in {time.time() - t1:.2f}s")
    iters = "INIT (unrefined)" if args.no_refine else f"{cfg.test.test_iter} refine iters"
    print(format_table(results, f"{cfg.experiment} — {iters}"))

    if args.vis:
        vis_dir = os.path.join(out_dir, "vis")
        nv = write_vis(assets, vis_dir, out["vis_rows"][:min(args.vis, n)], traj, pose_gt,
                       class_idx, ks, image_size)
        print(f"wrote {nv} overlay montages (INIT, {traj.shape[0] - 1} iters, GT) to {vis_dir}")
    with open(os.path.join(out_dir, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    if args.results_out:
        from deepim_tpu_torch.utils.results import record_result

        record_result(args.results_out, results, experiment=cfg.experiment, argv=argv)

    if args.save_poses:
        path = os.path.join(out_dir, "refined_poses.npz")
        np.savez_compressed(path, traj=traj_np, pose_gt=pose_gt, class_idx=class_idx, k=ks)
        print(f"wrote pose trajectories to {path}")
        if d.obj_ids:
            oid_map = np.asarray(list(d.obj_ids), np.int64)
            if int(class_idx.max(initial=0)) >= len(oid_map):
                raise SystemExit(f"class index {int(class_idx.max(initial=0))} is out of "
                                 f"range for dataset.obj_ids ({len(oid_map)} entries)")
            obj_col = oid_map[class_idx]
        else:
            obj_col = class_idx + 1
        scene_ids = im_ids = None
        if records is None:
            print("WARNING: generated data has no scene/frame ids; the BOP CSV gets "
                  "placeholder scene_id=0 / im_id=row ids")
        else:
            scene_ids, im_ids = bop_ids(records)
            if scene_ids is None:
                print("WARNING: scene/frame names are not numeric; the BOP CSV gets "
                      "placeholder scene_id=0 / im_id=row ids, which the BOP toolkit "
                      "cannot match against real ground truth")
        csv_path = os.path.join(out_dir, "bop_results.csv")
        write_bop_csv(csv_path, traj_np[-1], obj_col, scene_ids=scene_ids, im_ids=im_ids,
                      time_s=float(dt) / max(n_refined, 1))
        print(f"wrote BOP results CSV to {csv_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
