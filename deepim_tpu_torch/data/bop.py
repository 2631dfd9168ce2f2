"""BOP/SIXD-format dataset converter -> the LM6d layout.

Port of ``deepim_tpu/data/bop.py``.  It reads both forms the LINEMOD family
is released in:

    {root}/{split}/{scene}/
        rgb/{im:06d}.png                # BOP zero-pads to 6, SIXD to 4; or .jpg
        depth/{im}.png                  # uint16 * depth_scale = mm
        scene_gt.json  | gt.yml         # per-image list of
                                        #   {cam_R_m2c, cam_t_m2c (mm), obj_id}
        scene_camera.json | info.yml    # {cam_K, depth_scale}
        mask_visib/{im:06d}_{i:06d}.png # optional visible masks (BOP)
    {root}/models/obj_{id:06d}.ply      # mm (SIXD: obj_{id:02d}.ply)

Output: the layout :class:`deepim_tpu_torch.data.lm6d.LM6DDataset` reads
(metres, a pose text file per object, image sets).  Images are read with
:func:`deepim_tpu_torch.data.jpeg.imread` (PNG or baseline JPEG) and the
arithmetic is the reference's: float32 depth ``* depth_scale * 1e-3``,
then ``write_frame``'s truncating ``* 1000``, so the depth PNGs come out
equal to the reference converter's.  ``yaml`` is imported only where a
SIXD scene is read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from deepim_tpu_torch.data.jpeg import imread
from deepim_tpu_torch.data.lm6d import LM6DDataset

MM_TO_M = 1e-3


def _load_scene_annotations(sdir: str) -> tuple[dict, dict]:
    """(scene_gt, scene_camera) dicts keyed by str im_id, from BOP JSON or
    SIXD YAML, whichever the scene directory carries."""
    gt_json = os.path.join(sdir, "scene_gt.json")
    if os.path.exists(gt_json):
        with open(gt_json) as f:
            scene_gt = json.load(f)
        with open(os.path.join(sdir, "scene_camera.json")) as f:
            scene_cam = json.load(f)
        return scene_gt, scene_cam
    gt_yml = os.path.join(sdir, "gt.yml")
    if os.path.exists(gt_yml):
        import yaml

        with open(gt_yml) as f:
            scene_gt = {str(k): v for k, v in yaml.safe_load(f).items()}
        with open(os.path.join(sdir, "info.yml")) as f:
            scene_cam = {str(k): v for k, v in yaml.safe_load(f).items()}
        return scene_gt, scene_cam
    raise FileNotFoundError(f"{sdir}: neither scene_gt.json (BOP) nor gt.yml (SIXD) found")


def _find_image(dirpath: str, im_id: int) -> str | None:
    for pat in (f"{im_id:06d}.png", f"{im_id:04d}.png", f"{im_id:06d}.jpg", f"{im_id:04d}.jpg"):
        cand = os.path.join(dirpath, pat)
        if os.path.exists(cand):
            return cand
    return None


def _find_model(root: str, obj_id: int) -> str | None:
    for pat in (f"obj_{obj_id:06d}.ply", f"obj_{obj_id:02d}.ply"):
        cand = os.path.join(root, "models", pat)
        if os.path.exists(cand):
            return cand
    return None


def convert_bop_split(bop_root: str, split: str, out_root: str, obj_names: dict[int, str],
                      out_split: str = "test",
                      max_images_per_scene: int | None = None) -> LM6DDataset:
    """Convert one BOP split into the LM6d layout.

    ``obj_names``: BOP ``obj_id`` -> object name (the class order is the
    sorted obj_ids).  Scenes become LM6d scenes; meshes go from mm to
    metres."""
    from deepim_tpu_torch.raster.mesh import Mesh, load_ply

    names = [obj_names[k] for k in sorted(obj_names)]
    ids = {obj_names[k]: k for k in obj_names}
    ds = LM6DDataset(out_root, names)

    for name in names:
        ply = _find_model(bop_root, ids[name])
        if ply is None:
            raise FileNotFoundError(f"no obj_{ids[name]:06d}.ply / obj_{ids[name]:02d}.ply "
                                    f"under {bop_root}/models")
        mesh = load_ply(ply)
        ds.write_model(name, Mesh(mesh.vertices * MM_TO_M, mesh.faces, mesh.colors,
                                  mesh.normals))

    split_dir = os.path.join(bop_root, split)
    frames_per_obj: dict[str, list] = {n: [] for n in names}
    for scene in sorted(os.listdir(split_dir)):
        sdir = os.path.join(split_dir, scene)
        scene_gt, scene_cam = _load_scene_annotations(sdir)
        im_ids = sorted(scene_gt, key=int)
        if max_images_per_scene:
            im_ids = im_ids[:max_images_per_scene]
        for im_id in im_ids:
            frame = f"{int(im_id):06d}"
            rgb = imread(_find_image(os.path.join(sdir, "rgb"), int(im_id)))
            rgb = rgb.astype(np.float32) / 255.0
            depth_scale = scene_cam[im_id].get("depth_scale", 1.0)
            depth_path = _find_image(os.path.join(sdir, "depth"), int(im_id))
            if depth_path is not None:
                depth = imread(depth_path).astype(np.float32) * depth_scale * MM_TO_M
            else:
                depth = np.zeros(rgb.shape[:2], np.float32)

            poses = {}
            label = np.zeros(rgb.shape[:2], np.uint8)
            for gt_idx, gt in enumerate(scene_gt[im_id]):
                oid = int(gt["obj_id"])
                if oid not in obj_names:
                    continue
                name = obj_names[oid]
                r = np.asarray(gt["cam_R_m2c"], np.float32).reshape(3, 3)
                t = np.asarray(gt["cam_t_m2c"], np.float32) * MM_TO_M
                poses[name] = np.concatenate([r, t[:, None]], axis=1)
                mask_path = os.path.join(sdir, "mask_visib", f"{frame}_{gt_idx:06d}.png")
                if os.path.exists(mask_path):
                    label[imread(mask_path) > 0] = names.index(name) + 1
                frames_per_obj[name].append((scene, frame))
            ds.write_frame(scene, frame, rgb, depth, label, poses)

    for name in names:
        if frames_per_obj[name]:
            ds.write_image_set(name, out_split, frames_per_obj[name])
    return ds


def bop_camera_k(bop_root: str, split: str, scene: str) -> np.ndarray:
    """The first frame's K of a scene (BOP keeps K per image; the LM6d
    layout assumes one camera).  Reads BOP JSON or SIXD YAML."""
    _, cam = _load_scene_annotations(os.path.join(bop_root, split, scene))
    first = cam[sorted(cam, key=int)[0]]
    return np.asarray(first["cam_K"], np.float32).reshape(3, 3)
