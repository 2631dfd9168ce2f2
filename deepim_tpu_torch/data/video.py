"""Video pose-tracking datasets: the sequence layout and its generator.

Port of ``deepim_tpu/data/video.py``: ``VideoDataset`` (``sequences``,
``frame_ids``, ``objects_in``, ``init_poses``, ``load_sequence``,
``write_sequence``), ``gen_video`` and ``_render_frame``.  The layout
extends the LM6d one with ordered sequences and per-frame multi-object
poses:

    {root}/models/{obj}/textured.ply
    {root}/data/video/{seq}/{frame}-color.png / -depth.png / -label.png
    {root}/data/video/{seq}/{frame}-pose_{obj}.txt
    {root}/video_sets/{seq}.txt          # ordered frame ids, one per line
    {root}/video_sets/{seq}_objects.txt  # object names present in the seq
    {root}/init_poses/video_{seq}.txt    # (M, 3, 4) frame-0 inits
    {root}/gen_params.json               # gen_video's manifest

Label pixels are 1 + the object's slot in the sequence's object list (0:
background).  Each package reads the other's sequences.

Two differences from the reference.  ``gen_video`` draws from
``torch.Generator``s (the trajectories never equal the reference's, whose
JAX streams no torch generator reproduces) and writes a manifest of its
parameters, ``gen_params.json``, last, so a reader can tell whether a
directory holds what it asks for (:func:`video_manifest`,
:func:`read_manifest`).  ``_render_frame`` has one path: the scene render
and one batched depth render of the objects for the label, the kernels on
the card and their plain versions on the CPU.

The YCB-Video keyframe protocol is here too: ``video_sets/keyframe.txt``
(``keyframes``, ``write_keyframes``), a keyframe's images decoded once for
all of its objects (``load_frame_raw``, ``frame_mask``, ``load_keyframe``),
``keyframe_records``, ``iter_keyframe_batches`` (the keyframe counterpart
of :func:`~deepim_tpu_torch.data.lm6d.iter_frame_batches`: host slots,
:func:`~deepim_tpu_torch.data.lm6d.to_device`) and the PoseCNN ``.mat``
import ``apply_posecnn_mat_init`` (``scipy.io.loadmat``), and
``convert_ycb_original``, the converter of the original YCB-Video release
into this layout.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from functools import partial

import numpy as np
import torch

from deepim_tpu_torch.data.lm6d import (
    DEPTH_FACTOR, FrameRecord, HostSlots, LM6DDataset, thread_pool, stack_frames)
from deepim_tpu_torch.data.png import read_png, read_size, write_png

MANIFEST = "gen_params.json"


class VideoDataset:
    """Reader and writer of the sequence layout above."""

    def __init__(self, root: str, objects: list[str]):
        self.root = root
        self.objects = list(objects)
        self.class_to_idx = {o: i for i, o in enumerate(self.objects)}
        self._frames = LM6DDataset(root, objects)  # models and image IO

    def _vid(self, seq: str, frame: str, suffix: str) -> str:
        return os.path.join(self.root, "data", "video", seq, f"{frame}-{suffix}")

    def sequences(self) -> list[str]:
        d = os.path.join(self.root, "video_sets")
        # keyframe.txt is an eval frame list, not a sequence
        return sorted(f[:-4] for f in os.listdir(d)
                      if f.endswith(".txt") and not f.endswith("_objects.txt")
                      and f != "keyframe.txt")

    def frame_ids(self, seq: str) -> list[str]:
        with open(os.path.join(self.root, "video_sets", f"{seq}.txt")) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def objects_in(self, seq: str) -> list[str]:
        with open(os.path.join(self.root, "video_sets", f"{seq}_objects.txt")) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def init_poses(self, seq: str) -> np.ndarray | None:
        path = os.path.join(self.root, "init_poses", f"video_{seq}.txt")
        if not os.path.exists(path):
            return None
        return np.loadtxt(path, dtype=np.float32).reshape(-1, 3, 4)

    def load_sequence(self, seq: str, with_depths: bool = True, with_labels: bool = True,
                      start: int = 0, count: int | None = None) -> dict:
        """-> frames (T, H, W, 3) float32 in [0, 1], depths (T, H, W) metric
        (or None), labels (T, H, W) uint8 (or None), poses (T, M, 3, 4),
        class_idx (M,) and the object names.

        ``with_depths``/``with_labels`` False skip decoding that stream (it
        loads as None, as does a stream missing from disk); ``start`` and
        ``count`` load a window of frames, so a long sequence streams.
        """
        objs = self.objects_in(seq)
        fids = self.frame_ids(seq)
        fids = fids[start:start + count] if count is not None else fids[start:]
        read = self._frames._read_image
        frames, depths, labels, poses = [], [], [], []
        for fid in fids:
            frames.append(read(self._vid(seq, fid, "color.png")).astype(np.float32) / 255.0)
            dpath = self._vid(seq, fid, "depth.png")
            if with_depths and os.path.exists(dpath):
                depths.append(read(dpath).astype(np.float32) / DEPTH_FACTOR)
            lpath = self._vid(seq, fid, "label.png")
            if with_labels and os.path.exists(lpath):
                labels.append(read(lpath))
            poses.append(np.stack([
                np.loadtxt(self._vid(seq, fid, f"pose_{o}.txt"), dtype=np.float32).reshape(3, 4)
                for o in objs]))
        return {
            "frames": np.stack(frames),
            "depths": np.stack(depths) if len(depths) == len(fids) else None,
            "labels": np.stack(labels) if len(labels) == len(fids) else None,
            "poses": np.stack(poses),
            "class_idx": np.asarray([self.class_to_idx[o] for o in objs], np.int32),
            "objects": objs,
        }

    # -- the keyframe protocol (YCB-Video's evaluation) ----------------------

    def keyframes(self) -> list[tuple[str, str]]:
        """The keyframe test list ``video_sets/keyframe.txt`` (lines
        ``{seq}/{frame}``): YCB-Video evaluates these frames, batched per
        keyframe, not by tracking."""
        with open(os.path.join(self.root, "video_sets", "keyframe.txt")) as f:
            return [tuple(ln.strip().split("/")) for ln in f if ln.strip()]

    def has_keyframes(self) -> bool:
        return os.path.exists(os.path.join(self.root, "video_sets", "keyframe.txt"))

    def write_keyframes(self, pairs: list[tuple[str, str]]) -> None:
        os.makedirs(os.path.join(self.root, "video_sets"), exist_ok=True)
        with open(os.path.join(self.root, "video_sets", "keyframe.txt"), "w") as f:
            for seq, fid in pairs:
                f.write(f"{seq}/{fid}\n")

    def load_frame_samples(self, seq: str, frame: str):
        """One frame's PNG samples, decoded once: RGB uint8, depth uint16
        (zeros without a depth image) and the label (None without one)."""
        read = self._frames._read_image
        rgb = read(self._vid(seq, frame, "color.png"))
        dpath = self._vid(seq, frame, "depth.png")
        depth = read(dpath) if os.path.exists(dpath) else np.zeros(rgb.shape[:2], np.uint16)
        lpath = self._vid(seq, frame, "label.png")
        return rgb, depth, read(lpath) if os.path.exists(lpath) else None

    def load_frame_raw(self, seq: str, frame: str) -> dict:
        """One frame's shared images (RGB in [0, 1], metric depth, the raw
        label or None), decoded once for all of its objects."""
        rgb, depth, label = self.load_frame_samples(seq, frame)
        return {"obs_rgb": rgb.astype(np.float32) / 255.0,
                "obs_depth": depth.astype(np.float32) / DEPTH_FACTOR, "label": label}

    def frame_mask(self, raw: dict, seq: str, obj: str) -> np.ndarray:
        """One object's mask from a :meth:`load_frame_raw` dict: label
        pixels of 1 + its slot in ``{seq}_objects.txt``, else depth > 0."""
        if raw["label"] is not None:
            return raw["label"] == (self.objects_in(seq).index(obj) + 1)
        return raw["obs_depth"] > 0

    def load_keyframe(self, seq: str, frame: str, obj: str) -> dict:
        """One keyframe's observation of one object (RGB in [0, 1], metric
        depth, the object's mask)."""
        raw = self.load_frame_raw(seq, frame)
        return {"obs_rgb": raw["obs_rgb"], "obs_depth": raw["obs_depth"],
                "obs_mask": self.frame_mask(raw, seq, obj)}

    def keyframe_pose(self, seq: str, frame: str, obj: str) -> np.ndarray:
        return np.loadtxt(self._vid(seq, frame, f"pose_{obj}.txt"),
                          dtype=np.float32).reshape(3, 4)

    def write_sequence(self, seq: str, frame_ids: list[str], objs: list[str],
                       rgbs: np.ndarray, depths: np.ndarray, poses: np.ndarray,
                       init_poses: np.ndarray, labels: np.ndarray | None = None) -> None:
        """Write one sequence: RGB in [0, 1] (T, H, W, 3), metric depths (T,
        H, W), GT poses (T, M, 3, 4), frame-0 inits (M, 3, 4), optional
        labels (T, H, W)."""
        os.makedirs(os.path.join(self.root, "data", "video", seq), exist_ok=True)
        os.makedirs(os.path.join(self.root, "video_sets"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "init_poses"), exist_ok=True)
        for t, fid in enumerate(frame_ids):
            write_png(self._vid(seq, fid, "color.png"),
                      np.clip(rgbs[t] * 255, 0, 255).astype(np.uint8))
            write_png(self._vid(seq, fid, "depth.png"),
                      (depths[t] * DEPTH_FACTOR).astype(np.uint16))
            if labels is not None:
                write_png(self._vid(seq, fid, "label.png"), labels[t].astype(np.uint8))
            for m, o in enumerate(objs):
                np.savetxt(self._vid(seq, fid, f"pose_{o}.txt"), poses[t, m])
        with open(os.path.join(self.root, "video_sets", f"{seq}.txt"), "w") as f:
            f.write("\n".join(frame_ids) + "\n")
        with open(os.path.join(self.root, "video_sets", f"{seq}_objects.txt"), "w") as f:
            f.write("\n".join(objs) + "\n")
        np.savetxt(os.path.join(self.root, "init_poses", f"video_{seq}.txt"),
                   init_poses.reshape(-1, 12))


def video_manifest(objects: list[str], k: np.ndarray, image_size: tuple[int, int],
                   num_frames: int, num_sequences: int = 1, seed: int = 0,
                   objects_per_sequence: int | None = None, occluders: int = 0) -> dict:
    """What :func:`gen_video` writes to ``gen_params.json`` for these
    parameters, as it reads back from JSON."""
    return {
        "image_size": [int(image_size[0]), int(image_size[1])],
        "k": np.asarray(k, np.float32).astype(float).tolist(),
        "objects": list(objects),
        "num_frames": int(num_frames),
        "objects_per_sequence": objects_per_sequence,
        "occluders": int(occluders),
        "seed": int(seed),
        "num_sequences": int(num_sequences),
    }


def read_manifest(root: str) -> dict | None:
    """The manifest of a generated dataset, or None when it has none (not
    generated here, or its generation did not finish)."""
    path = os.path.join(root, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _trajectory(start: torch.Tensor, end: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(T, M, 3, 4): rotations slerped and translations lerped from
    ``start`` to ``end`` (M, 3, 4)."""
    from deepim_tpu_torch.geometry.rotations import mat2quat, quat2mat, quat_slerp

    q0, q1 = mat2quat(start[..., :3]), mat2quat(end[..., :3])
    poses = []
    for t in torch.linspace(0.0, 1.0, num_frames).tolist():
        q = quat_slerp(q0, q1, torch.full((start.shape[0],), t, device=start.device))
        tr = (1 - t) * start[..., 3] + t * end[..., 3]
        poses.append(torch.cat([quat2mat(q), tr[..., None]], -1))
    return torch.stack(poses)


def _occluder_poses(generator: torch.Generator, n_occ: int, k: np.ndarray,
                    image_size: tuple[int, int], num_frames: int) -> torch.Tensor:
    """(T, n_occ, 3, 4): boxes sweeping straight across the frustum in
    front of the tracked objects, over the middle of the clip."""
    from deepim_tpu_torch.geometry.rotations import euler2mat

    dev = generator.device
    z = 0.42 + 0.18 * torch.rand((n_occ,), generator=generator, device=dev)
    y = -0.06 + 0.12 * torch.rand((n_occ,), generator=generator, device=dev)
    ang = -1.5 + 3.0 * torch.rand((n_occ, 3), generator=generator, device=dev)
    r = euler2mat(ang[:, 0], ang[:, 1], ang[:, 2])
    half_w = 0.55 * image_size[1] / float(k[0, 0])  # ~ the frustum's half width
    sweep = torch.linspace(-half_w, half_w, num_frames).tolist()
    offs = torch.arange(n_occ, device=dev, dtype=torch.float32) * 0.08
    return torch.stack([
        torch.cat([r, torch.stack([(s + offs) * z, y, z], -1)[..., None]], -1)
        for s in sweep])


def gen_video(root: str, meshes: dict, k: np.ndarray, image_size: tuple[int, int],
              num_frames: int = 10, num_sequences: int = 1, seed: int = 0,
              objects_per_sequence: int | None = None, occluders: int = 0,
              device: torch.device | str = "cuda") -> VideoDataset:
    """Generate smooth-trajectory sequences rendered on ``device`` and write
    them under ``root`` -> the dataset.

    Frames match the training observations: a random light and a noise
    background.  ``objects_per_sequence`` splits the objects into groups,
    one sequence each (1: single-object sequences, the LM6d-style
    protocol; None: every object in every frame, YCB-style).
    ``occluders`` untracked boxes sweep across the frustum in front of the
    tracked objects; their pixels overwrite RGB and depth and zero the
    label, and leave the GT poses alone.

    Sequence ``s`` draws from one generator seeded ``seed + 101*s + 7``, in
    the reference's split order: start poses, end perturbation, init
    noise, lighting, then the occluders' poses and a background a frame.
    The occluder boxes' sizes come from ``np.random.RandomState(seed +
    91)``, as the reference's do.  ``gen_params.json``
    (:func:`video_manifest`) is written last.  Prints the render and PNG
    write ms a frame.
    """
    from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
    from deepim_tpu_torch.data.synthetic import random_lighting
    from deepim_tpu_torch.raster.mesh import box_mesh
    from deepim_tpu_torch.refine.refiner import build_assets, render_scene

    device = torch.device(device)
    objects = list(meshes)
    ds = VideoDataset(root, objects)
    for o in objects:
        ds._frames.write_model(o, meshes[o])
    assets = build_assets([meshes[o] for o in objects], num_points=256, device=device)
    kt = torch.as_tensor(np.asarray(k, np.float32), device=device)

    occ_assets = None
    if occluders:
        rng = np.random.RandomState(seed + 91)
        occ_assets = build_assets([box_mesh(tuple(rng.uniform(0.06, 0.14, 3)))
                                   for _ in range(occluders)], num_points=8, device=device)
        occ_cls = torch.arange(occluders, device=device)[None]
        occ_valid = torch.ones((1, occluders), dtype=torch.bool, device=device)

    group = objects_per_sequence or len(objects)
    groups = [list(range(g, min(g + group, len(objects))))
              for g in range(0, len(objects), group)]
    render_s = write_s = 0.0
    seq_id = 0
    for _ in range(num_sequences):
        for members in groups:
            t0 = time.perf_counter()
            m = len(members)
            g = torch.Generator(device=device).manual_seed(seed + 101 * seq_id + 7)
            start = sample_poses_in_frustum(g, m, kt, image_size, z_range=(0.7, 1.1))
            end = perturb_poses(g, start, rot_std_deg=25.0, rot_max_deg=60.0,
                                trans_std=(0.08, 0.08, 0.1), trans_max=(0.15, 0.15, 0.2))
            poses = _trajectory(start, end, num_frames)  # (T, M, 3, 4)
            inits = perturb_poses(g, poses[0], rot_std_deg=10.0, rot_max_deg=30.0,
                                  trans_std=(0.01, 0.01, 0.03), trans_max=(0.03, 0.03, 0.08))
            light = random_lighting(g)
            occ_poses = (_occluder_poses(g, occluders, k, image_size, num_frames)
                         if occluders else None)
            cls = torch.tensor(members, dtype=torch.int32, device=device)
            rgbs, depths, labels = [], [], []
            for t in range(num_frames):
                rgb, dep, lab = _render_frame(assets, cls, poses[t], kt, image_size, light)
                if occ_poses is not None:
                    orgb, odep = render_scene(occ_assets, occ_cls, occ_poses[t][None],
                                              occ_valid, kt[None], image_size, lighting=light)
                    orgb, odep = orgb[0], odep[0]
                    front = (odep > 0) & ((dep == 0) | (odep < dep))
                    rgb = torch.where(front[..., None], orgb, rgb)
                    dep = torch.where(front, odep, dep)
                    lab = torch.where(front, 0, lab)
                bg = torch.rand(rgb.shape, generator=g, device=device)
                rgb = torch.where((dep > 0)[..., None], rgb, bg)
                rgbs.append(rgb.cpu().numpy())
                depths.append(dep.cpu().numpy())
                labels.append(lab.cpu().numpy())
            t1 = time.perf_counter()
            ds.write_sequence(f"{seq_id:04d}", [f"{t:06d}" for t in range(num_frames)],
                              [objects[i] for i in members], np.stack(rgbs), np.stack(depths),
                              poses.cpu().numpy(), inits.cpu().numpy(), labels=np.stack(labels))
            render_s += t1 - t0
            write_s += time.perf_counter() - t1
            seq_id += 1
    manifest = video_manifest(objects, k, image_size, num_frames, num_sequences, seed,
                              objects_per_sequence, occluders)
    with open(os.path.join(root, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    n = max(seq_id * num_frames, 1)
    print(f"gen_video: {seq_id * num_frames} frames at {image_size[0]}x{image_size[1]} on "
          f"{device}: render {render_s / n * 1e3:.2f} ms a frame, PNG write "
          f"{write_s / n * 1e3:.2f} ms a frame")
    return ds


def _render_frame(assets, cls: torch.Tensor, poses: torch.Tensor, k: torch.Tensor,
                  image_size: tuple[int, int], lighting=None):
    """One frame of M objects -> rgb (H, W, 3), depth (H, W), label (H, W).

    ``cls`` (M,), ``poses`` (M, 3, 4), ``k`` (3, 3).  RGB and depth are
    the shared-z-buffer scene render; the scene raster does not expose the
    winning object, so the label (1 + the object's slot, 0 background)
    comes from one depth render of each object alone, all M in one batch,
    with the same z-test: the reference's non-"xla" branch.
    """
    from deepim_tpu_torch.raster.raster_ref import FLAT_LIGHTING
    from deepim_tpu_torch.refine.refiner import gather_class, render_crops, render_scene

    lighting = FLAT_LIGHTING if lighting is None else lighting
    m = cls.shape[0]
    valid = torch.ones((1, m), dtype=torch.bool, device=poses.device)
    rgb, depth = render_scene(assets, cls[None], poses[None], valid, k[None], image_size,
                              lighting=lighting)
    _, deps = render_crops(gather_class(assets, cls), poses, k.expand(m, 3, 3).contiguous(),
                           image_size, lighting=lighting)
    big = torch.where(deps > 0, deps, torch.inf)
    hit = (deps > 0).any(0)
    label = torch.where(hit, big.argmin(0).to(torch.int32) + 1, 0)
    return rgb[0], depth[0], label


def convert_ycb_original(src_root: str, out_root: str, class_names: list[str],
                         sequences: list[str] | None = None,
                         max_frames_per_seq: int | None = None) -> VideoDataset:
    """Convert the ORIGINAL YCB-Video release into the layout above:

        {src}/data/{seq}/{frame}-color.png, -depth.png, -label.png,
                         -meta.mat   # poses (3, 4, n), cls_indexes (1-based
                                     # into the 21-class list), factor_depth
        {src}/models/{name}/textured.obj (or .ply)
        {src}/image_sets/keyframe.txt   # lines "{seq}/{frame}"

    ``class_names``: the release's class names IN ORDER (``cls_indexes``
    are 1-based positions in it).  Frames are written one by one; label
    pixels go from global class ids to the sequence's slots (1 + the
    object's index in ``{seq}_objects.txt``); depth is rescaled from the
    release's ``factor_depth`` to ``DEPTH_FACTOR`` with the reference's
    float32 operations and truncation; poses stay in metres; colour PNGs
    are copied byte for byte (the reference re-encodes them through PIL:
    the same pixels); model directories are copied verbatim and each
    model is loaded once; the keyframe list is passed through, less
    sequences not converted."""
    from scipy.io import loadmat

    from deepim_tpu_torch.raster.mesh import load_mesh

    ds = VideoDataset(out_root, list(class_names))
    data_dir = os.path.join(src_root, "data")
    seqs = sequences or sorted(os.listdir(data_dir))

    seen_classes: set[int] = set()
    for seq in seqs:
        sdir = os.path.join(data_dir, seq)
        frames = sorted({f.split("-")[0] for f in os.listdir(sdir) if f.endswith("-color.png")})
        if max_frames_per_seq:
            frames = frames[:max_frames_per_seq]
        out_dir = os.path.join(out_root, "data", "video", seq)
        os.makedirs(out_dir, exist_ok=True)
        seq_cls: list[int] | None = None
        for fid in frames:
            meta = loadmat(os.path.join(sdir, f"{fid}-meta.mat"))
            cls0 = [int(c) - 1 for c in np.asarray(meta["cls_indexes"]).reshape(-1)]
            if seq_cls is None:
                seq_cls = cls0
                seen_classes.update(cls0)
            poses = np.asarray(meta["poses"], np.float32)  # (3, 4, n)
            factor = float(np.asarray(meta["factor_depth"]).reshape(-1)[0])
            for slot, ci in enumerate(cls0):
                np.savetxt(os.path.join(out_dir, f"{fid}-pose_{class_names[ci]}.txt"),
                           poses[:, :, slot])
            shutil.copyfile(os.path.join(sdir, f"{fid}-color.png"),
                            os.path.join(out_dir, f"{fid}-color.png"))
            dep = read_png(os.path.join(sdir, f"{fid}-depth.png")).astype(np.float32) / factor
            write_png(os.path.join(out_dir, f"{fid}-depth.png"),
                      (dep * DEPTH_FACTOR).astype(np.uint16))
            lab_path = os.path.join(sdir, f"{fid}-label.png")
            if os.path.exists(lab_path):
                lab = read_png(lab_path)
                out_lab = np.zeros_like(lab, dtype=np.uint8)
                for slot, ci in enumerate(cls0):
                    out_lab[lab == ci + 1] = slot + 1  # global id -> slot
                write_png(os.path.join(out_dir, f"{fid}-label.png"), out_lab)
        os.makedirs(os.path.join(out_root, "video_sets"), exist_ok=True)
        with open(os.path.join(out_root, "video_sets", f"{seq}.txt"), "w") as f:
            f.write("\n".join(frames) + "\n")
        with open(os.path.join(out_root, "video_sets", f"{seq}_objects.txt"), "w") as f:
            f.write("\n".join(class_names[c] for c in seq_cls) + "\n")

    for ci in sorted(seen_classes):
        name = class_names[ci]
        mdir = os.path.join(src_root, "models", name)
        if os.path.isdir(mdir):
            # verbatim (textured.obj + .mtl + texture map): the texture
            # survives, which an ASCII PLY re-encode would bake away
            out_mdir = os.path.join(out_root, "models", name)
            os.makedirs(out_mdir, exist_ok=True)
            for fn in os.listdir(mdir):
                shutil.copy2(os.path.join(mdir, fn), os.path.join(out_mdir, fn))
            load_mesh(ds._frames.model_path(name))  # it loads

    kf_src = os.path.join(src_root, "image_sets", "keyframe.txt")
    if os.path.exists(kf_src):
        with open(kf_src) as f:
            pairs = [tuple(ln.strip().split("/")) for ln in f if ln.strip()]
        ds.write_keyframes([p for p in pairs if p[0] in set(seqs)])
    return ds


def keyframe_records(ds: VideoDataset) -> list[FrameRecord]:
    """One record per (keyframe, object of its sequence), in keyframe
    order (scene = the sequence; ``init_pose`` None, filled downstream)."""
    records = []
    objs: dict[str, list[str]] = {}
    for seq, fid in ds.keyframes():
        if seq not in objs:
            objs[seq] = ds.objects_in(seq)
        for obj in objs[seq]:
            records.append(FrameRecord(scene=seq, frame=fid, obj=obj,
                                       class_idx=ds.class_to_idx[obj],
                                       pose=ds.keyframe_pose(seq, fid, obj), init_pose=None))
    return records


def iter_keyframe_batches(ds: VideoDataset, records, batch_size: int, pad_to: int | None = None,
                          pin_memory: bool | None = None, num_threads: int = 4,
                          extra: dict[str, np.ndarray] | None = None):
    """Keyframe batches of exactly ``batch_size`` records, as
    :func:`~deepim_tpu_torch.data.lm6d.iter_frame_batches` yields them.
    Each keyframe of a batch is decoded once, on the decode pool, and each
    of its records cuts its own mask from the shared label."""
    from deepim_tpu_torch.data.lm6d import _pin_default

    n = pad_to or len(records)
    if n % batch_size:
        raise ValueError(f"pad_to={n} is not a multiple of the batch size {batch_size}")
    recs = list(records) + [records[-1]] * (n - len(records))
    slots = HostSlots(_pin_default(pin_memory))
    pool = thread_pool(num_threads)
    size = read_size(ds._vid(recs[0].scene, recs[0].frame, "color.png"))
    slot_of = {}  # (seq, obj) -> the object's label value
    for r in recs:
        if (r.scene, r.obj) not in slot_of:
            slot_of[(r.scene, r.obj)] = ds.objects_in(r.scene).index(r.obj) + 1

    def cut(decoded, r):
        rgb, depth, label = decoded[(r.scene, r.frame)]
        return rgb, depth, (label == slot_of[(r.scene, r.obj)] if label is not None
                            else depth > 0)

    for i in range(0, n, batch_size):
        batch = recs[i:i + batch_size]
        keys = list(dict.fromkeys((r.scene, r.frame) for r in batch))
        decoded = dict(zip(keys, pool.map(lambda k: ds.load_frame_samples(*k), keys)))
        yield stack_frames(slots, pool, [partial(cut, decoded, r) for r in batch], size,
                           {k: v[i:i + batch_size] for k, v in (extra or {}).items()})


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion, normalised -> (3, 3) rotation (numpy)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def apply_posecnn_mat_init(records, init: np.ndarray, results_dir: str,
                           obj_ids: list[int] | None = None, pose_key: str = "poses") -> int:
    """PoseCNN's released per-keyframe results as init poses -> the match
    count; ``init`` is changed in place.

    One MATLAB file per keyframe, named by its 0-based line in
    keyframe.txt (``000000.mat``, ...), with ``rois`` (column 1: the
    1-based class id of each detection) and ``poses`` (per detection: wxyz
    quaternion, then txyz).  ``records`` are :func:`keyframe_records` rows
    in order; ``obj_ids`` maps ``class_idx`` to the release's class ids
    (default ``class_idx + 1``).  The first detection of a class wins.
    """
    from scipy.io import loadmat

    kf_index: dict[tuple[str, str], int] = {}
    for r in records:
        kf_index.setdefault((r.scene, r.frame), len(kf_index))
    matched = 0
    cache: dict[int, tuple[np.ndarray, np.ndarray] | None] = {}
    for i, rec in enumerate(records):
        ki = kf_index[(rec.scene, rec.frame)]
        if ki not in cache:
            path = os.path.join(results_dir, f"{ki:06d}.mat")
            if os.path.exists(path):
                m = loadmat(path)
                cache[ki] = (np.atleast_2d(np.asarray(m["rois"])),
                             np.atleast_2d(np.asarray(m[pose_key])))
            else:
                cache[ki] = None
        if cache[ki] is None:
            continue
        rois, poses = cache[ki]
        want = obj_ids[rec.class_idx] if obj_ids else rec.class_idx + 1
        rows = np.nonzero(rois[:, 1].astype(int) == int(want))[0]
        if rows.size == 0:
            continue
        p = np.asarray(poses[rows[0]], np.float32).reshape(-1)
        init[i, :, :3] = _quat_to_mat_np(p[:4])
        init[i, :, 3] = p[4:7]
        matched += 1
    return matched
