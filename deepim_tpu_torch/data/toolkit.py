"""Dataset preparation: generate an on-disk LM6d-layout dataset on the device.

Port of ``deepim_tpu/data/toolkit.py`` (``gen_observed``, ``gen_rendered``,
``gen_procedural_dataset``): the framework's own rasterizer renders GT-pose
frames and perturbed views, and :class:`~deepim_tpu_torch.data.lm6d.LM6DDataset`
writes the layout the readers (both packages') take.

Two differences from the reference.  The reference renders with its XLA
oracle (``renderer="xla"``); the port renders with ``render_crops``, the
crop dispatch (the sorted kernel under 1,024 faces, else the cols kernel;
their plain versions on the CPU), as ``synthetic_batch`` does for full
frames.  The sorted route keeps at most 128 big-bbox faces in its global
list (ROADMAP C.2); at 0.5-1.4 m an object's faces are small in a 480x640
frame and the cap does not bind (``tests/test_torch_toolkit.py`` holds the
render to the reference's XLA one).  And the poses are drawn from
``torch.Generator``s on the device, so they never equal the reference's
JAX draws; the split permutation is the reference's
``np.random.RandomState(seed)``, so split sizes and frame order agree.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from deepim_tpu_torch.data.lm6d import LM6DDataset, thread_pool
from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES, Mesh

WRITE_THREADS = 8  # PNG writers (zlib compresses without the GIL)


def render_frames(assets, class_index: int, poses: torch.Tensor, k: torch.Tensor,
                  image_size: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Full frames of class ``class_index`` at ``poses`` (n, 3, 4) under flat
    lighting -> rgb (n, H, W, 3), depth (n, H, W), on the assets' device."""
    from deepim_tpu_torch.refine.refiner import gather_class, render_crops

    n = poses.shape[0]
    dev = assets.points.device
    cls = torch.full((n,), class_index, dtype=torch.int64, device=dev)
    ks = k.to(dev).expand(n, 3, 3).contiguous()
    return render_crops(gather_class(assets, cls), poses.to(dev), ks, image_size)


def _write_all(fn, n: int) -> None:
    """``fn(i)`` for every i < n on the writer threads, returning when all
    are done (re-raising the first failure)."""
    list(thread_pool(WRITE_THREADS).map(fn, range(n)))


def gen_observed(root: str, meshes: dict[str, Mesh], k: np.ndarray, image_size: tuple[int, int],
                 frames_per_obj: int = 20, split_fracs: dict[str, float] | None = None,
                 seed: int = 0, z_range: tuple[float, float] = (0.5, 1.4),
                 init_noise: tuple[float, float] = (15.0, 0.05),
                 device: torch.device | str = "cuda") -> LM6DDataset:
    """Render GT-pose frames of each object on ``device`` and write the whole
    layout under ``root``: models, frames with labels and poses, the
    splits' image sets and, standing in for imported PoseCNN results,
    perturbed init poses (``init_noise``: rotation std in degrees,
    translation std in metres) -> the dataset.

    Object ``ci`` (scene ``{ci:02d}``) draws its poses, then its inits,
    from one generator seeded ``seed + ci``.  Prints the render and PNG
    write ms a frame.
    """
    from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
    from deepim_tpu_torch.refine.refiner import build_assets

    device = torch.device(device)
    split_fracs = split_fracs or {"train": 0.7, "test": 0.3}
    objects = list(meshes)
    ds = LM6DDataset(root, objects)
    assets = build_assets([meshes[o] for o in objects], num_points=256, device=device)
    kt = torch.as_tensor(np.asarray(k, np.float32), device=device)
    render_s = write_s = 0.0
    for ci, obj in enumerate(objects):
        t0 = time.perf_counter()
        ds.write_model(obj, meshes[obj])
        g = torch.Generator(device=device).manual_seed(seed + ci)
        poses = sample_poses_in_frustum(g, frames_per_obj, kt, image_size, z_range)
        inits = perturb_poses(g, poses, rot_std_deg=init_noise[0], rot_max_deg=45.0,
                              trans_std=(init_noise[1],) * 3, trans_max=(0.1, 0.1, 0.2))
        rgb, depth = render_frames(assets, ci, poses, kt, image_size)
        rgb, depth = rgb.cpu().numpy(), depth.cpu().numpy()
        poses_np, inits_np = poses.cpu().numpy(), inits.cpu().numpy()
        t1 = time.perf_counter()
        scene = f"{ci:02d}"
        frames = [(scene, f"{fi:06d}") for fi in range(frames_per_obj)]

        def write(fi):  # run to the end before the loop moves on
            label = np.where(depth[fi] > 0, ci + 1, 0).astype(np.uint8)
            ds.write_frame(scene, frames[fi][1], rgb[fi], depth[fi], label, {obj: poses_np[fi]})

        _write_all(write, frames_per_obj)
        # The splits and their init poses.
        start = 0
        order = np.random.RandomState(seed).permutation(frames_per_obj)
        for split, frac in split_fracs.items():
            cnt = max(1, int(round(frac * frames_per_obj)))
            idx = order[start:start + cnt]
            start += cnt
            ds.write_image_set(obj, split, [frames[i] for i in idx])
            ds.write_init_poses(obj, split, inits_np[idx])
        render_s += t1 - t0
        write_s += time.perf_counter() - t1
    n = max(len(objects) * frames_per_obj, 1)
    print(f"gen_observed: {n} frames at {image_size[0]}x{image_size[1]} on {device}: render "
          f"{render_s / n * 1e3:.2f} ms a frame, PNG write {write_s / n * 1e3:.2f} ms a frame")
    return ds


def gen_rendered(ds: LM6DDataset, meshes: dict[str, Mesh], k: np.ndarray,
                 image_size: tuple[int, int], split: str = "train", per_frame: int = 1,
                 noise: tuple[float, float] = (15.0, 0.05), seed: int = 0,
                 device: torch.device | str = "cuda") -> int:
    """Render ``per_frame`` perturbed views of every ``split`` frame on
    ``device`` and write them under ``data/rendered/{obj}/{scene}/`` ->
    the number written.  View ``i`` of object ``ci`` draws from a generator
    seeded ``seed * 1000003 + ci * 1009 + i`` (``noise``: rotation std in
    degrees, translation std in metres)."""
    from deepim_tpu_torch.data.pairs import perturb_poses
    from deepim_tpu_torch.refine.refiner import build_assets

    device = torch.device(device)
    objects = list(meshes)
    assets = build_assets([meshes[o] for o in objects], num_points=256, device=device)
    kt = torch.as_tensor(np.asarray(k, np.float32), device=device)
    written = 0
    for ci, obj in enumerate(objects):
        recs = ds.gt_roidb(obj, split)
        if not recs:
            continue
        gt = torch.from_numpy(np.stack([r.pose for r in recs])).to(device)
        for i in range(per_frame):
            g = torch.Generator(device=device).manual_seed(seed * 1000003 + ci * 1009 + i)
            src = perturb_poses(g, gt, rot_std_deg=noise[0], rot_max_deg=45.0,
                                trans_std=(noise[1],) * 3, trans_max=(0.1, 0.1, 0.2))
            rgb, depth = render_frames(assets, ci, src, kt, image_size)
            rgb, depth, src_np = rgb.cpu().numpy(), depth.cpu().numpy(), src.cpu().numpy()

            def write(fi):
                ds.write_rendered(obj, recs[fi].scene, recs[fi].frame, i, rgb[fi], depth[fi],
                                  src_np[fi])

            _write_all(write, len(recs))
            written += len(recs)
    return written


def gen_procedural_dataset(root: str, objects: list[str], k: np.ndarray,
                           image_size: tuple[int, int], frames_per_obj: int = 20,
                           seed: int = 0, device: torch.device | str = "cuda") -> LM6DDataset:
    """A stand-in for LINEMOD: the procedural meshes ``objects`` through
    :func:`gen_observed`."""
    meshes = {name: PROCEDURAL_MESHES[name]() for name in objects}
    return gen_observed(root, meshes, k, image_size, frames_per_obj, seed=seed, device=device)
