"""Real-data preflight: check a dataset drop before any run.

Port of ``deepim_tpu/data/validate.py``: every check, code and message of
the reference, as the same ``Finding(level, code, path, message)`` records
and the same :func:`format_findings` text.  A real LINEMOD/YCB/BOP drop has
half a dozen silent ways to be wrong (depth factor, mm against m poses,
world-to-camera rotations, mesh units, label id conventions), each giving a
plausible-looking but meaningless evaluation; this module checks a root
against the conventions the readers assume and says what to do.  Images
are read with :func:`deepim_tpu_torch.data.jpeg.imread` and meshes with
:func:`deepim_tpu_torch.raster.mesh.load_mesh`.

Use via ``python -m deepim_tpu_torch.cli.validate_dataset <root> [--format auto]``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from deepim_tpu_torch.data.jpeg import imread

__all__ = ["Finding", "validate_lm6d", "validate_bop", "validate_ycb_video",
           "detect_format", "validate", "format_findings"]

# Plausibility windows for a camera-frame object pose in METERS.
_TZ_RANGE = (0.05, 5.0)  # LINEMOD ~0.6-1.2 m, YCB ~0.5-2 m
_MESH_DIAMETER_RANGE = (0.005, 1.5)  # meters; LINEMOD 0.1-0.3 m
_DEPTH_RANGE_M = (0.05, 10.0)


@dataclass
class Finding:
    level: str  # "ERROR" | "WARN" | "INFO"
    code: str  # stable slug, e.g. "pose-translation-units"
    path: str  # file/dir the finding is about
    message: str  # actionable: what is wrong AND what to do

    def __str__(self):
        return f"[{self.level}] {self.code}: {self.path}\n    {self.message}"


def _errors(findings):
    return [f for f in findings if f.level == "ERROR"]


def format_findings(findings: list[Finding]) -> str:
    if not findings:
        return "OK: no findings — dataset passes preflight"
    lines = [str(f) for f in findings]
    ne = len(_errors(findings))
    lines.append(f"{ne} error(s), {len(findings) - ne} warning(s)")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# shared checks


def check_pose(pose: np.ndarray, where: str,
               what: str = "pose") -> list[Finding]:
    """Camera-frame 3x4 pose sanity: orthonormal right-handed R, metric t,
    object in FRONT of the camera.  Catches the classic converter bugs:
    mm translations, world-to-camera (inverted) poses, transposed /
    reflected rotation axes, OpenGL-flipped z."""
    out = []
    pose = np.asarray(pose, np.float64)
    if pose.shape != (3, 4):
        return [Finding("ERROR", "pose-shape", where,
                        f"{what} has shape {pose.shape}, expected (3, 4) "
                        "row-major [R|t]")]
    r, t = pose[:, :3], pose[:, 3]
    if not np.isfinite(pose).all():
        return [Finding("ERROR", "pose-nonfinite", where,
                        f"{what} contains NaN/inf")]
    ortho = np.abs(r @ r.T - np.eye(3)).max()
    if ortho > 1e-2:
        out.append(Finding(
            "ERROR", "pose-rotation-not-orthonormal", where,
            f"{what} rotation is not orthonormal (|RRt-I|max={ortho:.3g}) "
            "— scaled/sheared axes usually mean the matrix was read "
            "transposed or includes the camera K"))
    elif np.linalg.det(r) < 0:
        out.append(Finding(
            "ERROR", "pose-rotation-reflected", where,
            f"{what} rotation has det=-1 (a reflection) — one axis is "
            "flipped; check for an OpenCV<->OpenGL y/z flip applied once "
            "instead of twice"))
    tn = np.linalg.norm(t)
    if 100.0 * _TZ_RANGE[0] <= tn <= 1000.0 * _TZ_RANGE[1]:
        out.append(Finding(
            "ERROR", "pose-translation-units", where,
            f"{what} |t|={tn:.1f} — looks like millimeters (or "
            "centimeters); the readers expect METERS.  BOP/SIXD "
            "cam_t_m2c and the original LINEMOD .tra files are not "
            "metric — scale by 1e-3 (mm) / 1e-2 (cm) at conversion"))
    elif not (_TZ_RANGE[0] <= tn <= _TZ_RANGE[1]):
        out.append(Finding(
            "WARN", "pose-translation-range", where,
            f"{what} |t|={tn:.3f} m is outside the plausible camera "
            f"range {_TZ_RANGE} — verify units and frame convention"))
    if t[2] < 0:
        out.append(Finding(
            "ERROR", "pose-behind-camera", where,
            f"{what} t_z={t[2]:.3f} < 0 puts the object BEHIND the "
            "camera — a world-to-camera pose (cam_R_w2c: invert it) or "
            "an OpenGL-convention z (negate y/z rows) was stored as "
            "model-to-camera"))
    return out


def check_mesh_scale(path: str, loader=None) -> list[Finding]:
    """Mesh loads and is meter-scale (BOP/SIXD .ply ships in mm)."""
    if loader is None:
        from deepim_tpu_torch.raster.mesh import load_mesh
        loader = load_mesh
    try:
        mesh = loader(path)
    except Exception as e:  # noqa: BLE001 — report, don't crash preflight
        return [Finding("ERROR", "mesh-unloadable", path,
                        f"mesh failed to load: {e!r}")]
    v = np.asarray(mesh.vertices)
    if v.size == 0:
        return [Finding("ERROR", "mesh-empty", path, "mesh has 0 vertices")]
    diam = float(np.linalg.norm(v.max(0) - v.min(0)))
    lo, hi = _MESH_DIAMETER_RANGE
    if 1000 * lo <= diam <= 1000 * hi:
        return [Finding(
            "ERROR", "mesh-units-mm", path,
            f"mesh bounding diameter {diam:.1f} — looks like millimeters "
            "(BOP/SIXD models ship in mm); scale vertices by 1e-3 "
            "(data/bop.py §convert_bop_split does this)")]
    if not (lo <= diam <= hi):
        return [Finding(
            "WARN", "mesh-scale", path,
            f"mesh bounding diameter {diam:.4f} m outside plausible "
            f"object range {_MESH_DIAMETER_RANGE}")]
    return []


def _check_depth_file(path: str, read_image, depth_factor: float,
                      tz: float | None, mask: np.ndarray | None
                      ) -> list[Finding]:
    """Depth decodes to plausible meters and agrees with the pose's z."""
    out = []
    raw = read_image(path)
    if raw.dtype != np.uint16:
        out.append(Finding(
            "WARN", "depth-dtype", path,
            f"depth png decodes to {raw.dtype}, expected uint16 "
            f"(meters * {depth_factor:g})"))
    depth = raw.astype(np.float64) / depth_factor
    nz = depth[depth > 0]
    if nz.size == 0:
        out.append(Finding("WARN", "depth-empty", path,
                           "depth image is all zeros"))
        return out
    med = float(np.median(nz))
    if not (_DEPTH_RANGE_M[0] <= med <= _DEPTH_RANGE_M[1]):
        guess = ("10000 (original YCB-Video release)"
                 if 0.5 <= med * depth_factor / 10000.0 <= 10.0
                 else "the release's depth_scale")
        out.append(Finding(
            "ERROR", "depth-factor", path,
            f"median nonzero depth {med:.3f} m (factor {depth_factor:g}) "
            f"is implausible — the file was probably written with factor "
            f"{guess}; re-run the converter (data/video.py "
            "§convert_ycb_original rescales 10000 -> 1000)"))
        return out
    if tz is not None and mask is not None and mask.any():
        obj_depth = depth[mask]
        obj_nz = obj_depth[obj_depth > 0]
        if obj_nz.size:
            med_obj = float(np.median(obj_nz))
            if abs(med_obj - tz) > max(0.25 * tz, 0.1):
                out.append(Finding(
                    "ERROR", "depth-pose-mismatch", path,
                    f"median depth inside the object mask ({med_obj:.3f} "
                    f"m) disagrees with the GT pose z ({tz:.3f} m) by "
                    f">25% — depth factor and pose units are "
                    "inconsistent with each other"))
    return out


# --------------------------------------------------------------------------
# LM6d_converted layout (the framework's on-disk format)


def validate_lm6d(root: str, objects: list[str] | None = None,
                  split: str = "test",
                  max_frames_per_obj: int = 3) -> list[Finding]:
    """Preflight an LM6d_converted-layout drop (data/lm6d.py's contract)."""
    from deepim_tpu_torch.data.lm6d import DEPTH_FACTOR, LM6DDataset

    out: list[Finding] = []
    if not os.path.isdir(root):
        return [Finding("ERROR", "root-missing", root, "not a directory")]
    mdir = os.path.join(root, "models")
    if objects is None:
        objects = sorted(os.listdir(mdir)) if os.path.isdir(mdir) else []
    if not objects:
        return [Finding("ERROR", "no-objects", mdir,
                        "no models/<obj>/ directories and no explicit "
                        "object list — nothing to validate")]
    ds = LM6DDataset(root, objects)

    for d, code in ((os.path.join(root, "data", "observed"), "observed"),
                    (os.path.join(root, "image_set", "observed"),
                     "image-set")):
        if not os.path.isdir(d):
            out.append(Finding("ERROR", f"layout-{code}-missing", d,
                               "required directory absent"))
    if _errors(out):
        return out

    for obj in objects:
        mp = ds.model_path(obj)
        if not os.path.exists(mp):
            out.append(Finding(
                "ERROR", "model-missing", mp,
                f"no mesh for '{obj}' (tried {LM6DDataset.MODEL_CANDIDATES})"))
        else:
            out += check_mesh_scale(mp)

        isp = ds._imageset_path(obj, split)
        if not os.path.exists(isp):
            out.append(Finding(
                "WARN", "image-set-missing", isp,
                f"no {split} image set for '{obj}' — gt_roidb('{obj}', "
                f"'{split}') will fail"))
            continue
        frames = ds.frame_list(obj, split)
        if not frames:
            out.append(Finding("WARN", "image-set-empty", isp,
                               "image set has no frames"))
            continue

        inits = ds._load_init_poses(obj, split)
        if inits is not None and len(inits) != len(frames):
            out.append(Finding(
                "ERROR", "init-poses-count",
                os.path.join(root, "init_poses", f"{obj}_{split}.txt"),
                f"{len(inits)} init poses vs {len(frames)} image-set "
                "frames — rows must be parallel to the image set"))

        for scene, frame in frames[:max_frames_per_obj]:
            cpath = ds._obs(scene, frame, "color.png")
            ppath = ds._obs(scene, frame, f"pose_{obj}.txt")
            if not os.path.exists(cpath):
                out.append(Finding(
                    "ERROR", "frame-missing", cpath,
                    f"image set {isp} lists {scene}/{frame} but the "
                    "color png is absent"))
                continue
            if not os.path.exists(ppath):
                out.append(Finding("ERROR", "pose-missing", ppath,
                                   "GT pose file absent for listed frame"))
                continue
            try:
                pose = np.loadtxt(ppath, dtype=np.float64).reshape(3, 4)
            except Exception as e:  # noqa: BLE001
                out.append(Finding("ERROR", "pose-unparsable", ppath,
                                   f"{e!r} — expected 12 floats (3x4)"))
                continue
            out += check_pose(pose, ppath)

            # label convention: uint8 class-id mask, id = class_idx + 1
            lpath = ds._obs(scene, frame, "label.png")
            mask = None
            if os.path.exists(lpath):
                label = imread(lpath)
                mx = int(label.max())
                if mx > len(objects):
                    out.append(Finding(
                        "ERROR", "label-id-range", lpath,
                        f"label contains id {mx} > num_objects "
                        f"{len(objects)} — LM6d labels are 1-based class "
                        "ids over the configured object list (0 = "
                        "background); YCB per-sequence slot labels must "
                        "be remapped (data/video.py §convert_ycb_original)"))
                mask = label == (ds.class_to_idx[obj] + 1)
                if not mask.any():
                    out.append(Finding(
                        "WARN", "label-object-absent", lpath,
                        f"label has no pixels with id "
                        f"{ds.class_to_idx[obj] + 1} ('{obj}') although "
                        "the frame is in its image set"))
            dpath = ds._obs(scene, frame, "depth.png")
            if os.path.exists(dpath):
                out += _check_depth_file(dpath, imread, DEPTH_FACTOR,
                                         float(pose[2, 3]), mask)
    return out


# --------------------------------------------------------------------------
# BOP / SIXD source trees (pre-conversion)


def validate_bop(root: str, split: str,
                 max_images_per_scene: int = 2) -> list[Finding]:
    """Preflight a BOP/SIXD source tree BEFORE convert_bop_split.

    Checks the conventions data/bop.py assumes: per-scene
    scene_gt.json/gt.yml with cam_R_m2c + cam_t_m2c in mm, scene_camera
    with a 9-float cam_K and sane depth_scale, mm meshes, zero-padded
    image names."""
    from deepim_tpu_torch.data.bop import _find_image, _load_scene_annotations

    out: list[Finding] = []
    split_dir = os.path.join(root, split)
    if not os.path.isdir(split_dir):
        return [Finding("ERROR", "split-missing", split_dir,
                        "split directory absent")]
    models = os.path.join(root, "models")
    if os.path.isdir(models):
        plys = [f for f in sorted(os.listdir(models))
                if f.startswith("obj_") and f.endswith(".ply")]
        for f in plys[:3]:
            p = os.path.join(models, f)
            # BOP meshes MUST be mm — meters here means double-scaling
            mm_findings = check_mesh_scale(p)
            if not any(fi.code == "mesh-units-mm" for fi in mm_findings):
                out.append(Finding(
                    "WARN", "bop-mesh-not-mm", p,
                    "BOP/SIXD models are expected in millimeters (the "
                    "converter scales by 1e-3); this one looks meter-"
                    "scale already — converting it would shrink the "
                    "object 1000x"))
    else:
        out.append(Finding("WARN", "models-missing", models,
                           "no models/ directory next to the split"))

    scenes = sorted(d for d in os.listdir(split_dir)
                    if os.path.isdir(os.path.join(split_dir, d)))
    if not scenes:
        return out + [Finding("ERROR", "no-scenes", split_dir,
                              "split has no scene directories")]
    for scene in scenes:
        sdir = os.path.join(split_dir, scene)
        try:
            scene_gt, scene_cam = _load_scene_annotations(sdir)
        except FileNotFoundError as e:
            out.append(Finding("ERROR", "annotations-missing", sdir, str(e)))
            continue
        im_ids = sorted(scene_gt, key=int)[:max_images_per_scene]
        for im_id in im_ids:
            where = f"{sdir} im {im_id}"
            cam = scene_cam.get(im_id, {})
            k = np.asarray(cam.get("cam_K", []), np.float64).reshape(-1)
            if k.size != 9:
                out.append(Finding(
                    "ERROR", "cam-k-shape", where,
                    f"cam_K has {k.size} values, expected 9"))
            elif k[0] <= 0 or k[4] <= 0:
                out.append(Finding("ERROR", "cam-k-values", where,
                                   f"fx={k[0]}, fy={k[4]} must be positive"))
            dsc = float(cam.get("depth_scale", 1.0))
            if not (1e-3 <= dsc <= 100.0):
                out.append(Finding(
                    "ERROR", "depth-scale", where,
                    f"depth_scale={dsc} implausible (uint16*scale should "
                    "be mm; typical 0.1 or 1.0)"))
            if _find_image(os.path.join(sdir, "rgb"), int(im_id)) is None:
                out.append(Finding(
                    "ERROR", "rgb-missing", os.path.join(sdir, "rgb"),
                    f"no rgb image for im_id {im_id} (tried 6- and 4-digit "
                    "zero padding, png/jpg)"))
            for gt in scene_gt[im_id]:
                if "cam_R_w2c" in gt or "cam_t_w2c" in gt:
                    out.append(Finding(
                        "ERROR", "pose-w2c", where,
                        "annotation carries cam_R_w2c/cam_t_w2c (WORLD-to-"
                        "camera, a scene_camera field) where the converter "
                        "needs the model-to-camera cam_R_m2c/cam_t_m2c "
                        "object pose — wrong key or wrong file"))
                    continue
                if "cam_R_m2c" not in gt or "cam_t_m2c" not in gt:
                    out.append(Finding(
                        "ERROR", "pose-keys", where,
                        f"gt entry keys {sorted(gt)} lack "
                        "cam_R_m2c/cam_t_m2c"))
                    continue
                r = np.asarray(gt["cam_R_m2c"], np.float64).reshape(3, 3)
                t_mm = np.asarray(gt["cam_t_m2c"], np.float64).reshape(3)
                tn_mm = float(np.linalg.norm(t_mm))
                if tn_mm < 10.0:
                    out.append(Finding(
                        "ERROR", "bop-t-meters", where,
                        f"cam_t_m2c norm {tn_mm:.4f} — BOP/SIXD stores "
                        "MILLIMETERS; this looks like meters, and the "
                        "converter's 1e-3 scaling would shrink it 1000x"))
                    continue
                pose_m = np.concatenate([r, t_mm[:, None] * 1e-3], axis=1)
                # after the converter's documented mm->m scaling the pose
                # must be a plausible camera-frame pose
                for f in check_pose(pose_m, where, what="cam_*_m2c (mm->m)"):
                    if f.code == "pose-translation-units":
                        f.message = (
                            f"cam_t_m2c norm {np.linalg.norm(t_mm):.4f} — "
                            "BOP stores MILLIMETERS; this looks like "
                            "meters, so the converter's 1e-3 scaling "
                            "would shrink it 1000x")
                    out.append(f)
    return out


# --------------------------------------------------------------------------
# YCB-Video layout (data/video.py's contract)


def validate_ycb_video(root: str, max_keyframes: int = 4) -> list[Finding]:
    """Preflight a converted YCB-Video drop (VideoDataset's contract):
    sequence lists, per-sequence slot labels, keyframe coverage, PNG
    depth at the framework factor, metric camera-frame poses."""
    from deepim_tpu_torch.data.lm6d import DEPTH_FACTOR
    from deepim_tpu_torch.data.video import VideoDataset

    out: list[Finding] = []
    if not os.path.isdir(root):
        return [Finding("ERROR", "root-missing", root, "not a directory")]
    ds = VideoDataset(root, [])
    try:
        seqs = ds.sequences()
    except FileNotFoundError:
        return [Finding("ERROR", "video-sets-missing",
                        os.path.join(root, "video_sets"),
                        "no video_sets/ sequence lists")]
    if not seqs:
        return [Finding("ERROR", "no-sequences", root,
                        "video_sets lists no sequences")]
    if not ds.has_keyframes():
        out.append(Finding(
            "WARN", "keyframes-missing",
            os.path.join(root, "video_sets", "keyframe.txt"),
            "no keyframe list — cli.test's ycb_video protocol needs it "
            "(cli.track works without)"))
        kfs = []
    else:
        kfs = ds.keyframes()
        seqset = set(seqs)
        bad = [f"{s}/{f}" for s, f in kfs if s not in seqset]
        if bad:
            out.append(Finding(
                "ERROR", "keyframe-unknown-seq",
                os.path.join(root, "video_sets", "keyframe.txt"),
                f"{len(bad)} keyframes reference sequences absent from "
                f"video_sets (first: {bad[0]})"))
    seqset = set(seqs)
    for seq, fid in [kf for kf in kfs if kf[0] in seqset][:max_keyframes]:
        objs = ds.objects_in(seq)
        cpath = ds._vid(seq, fid, "color.png")
        if not os.path.exists(cpath):
            out.append(Finding("ERROR", "keyframe-frame-missing", cpath,
                               "keyframe listed but color png absent"))
            continue
        raw = ds.load_frame_raw(seq, fid)
        if raw["label"] is not None and int(raw["label"].max()) > len(objs):
            out.append(Finding(
                "ERROR", "label-slot-range", ds._vid(seq, fid, "label.png"),
                f"label id {int(raw['label'].max())} exceeds the "
                f"{len(objs)} objects of {seq}_objects.txt — video labels "
                "are 1 + per-sequence slot; the ORIGINAL release's global "
                "class ids must be remapped (convert_ycb_original does)"))
        for obj in objs:
            pp = ds._vid(seq, fid, f"pose_{obj}.txt")
            if not os.path.exists(pp):
                out.append(Finding("ERROR", "keyframe-pose-missing", pp,
                                   "object listed for sequence but no "
                                   "pose file at keyframe"))
                continue
            pose = ds.keyframe_pose(seq, fid, obj)
            out += check_pose(pose, pp)
            dpath = ds._vid(seq, fid, "depth.png")
            if os.path.exists(dpath):
                mask = ds.frame_mask(raw, seq, obj)
                out += _check_depth_file(dpath, imread,
                                         DEPTH_FACTOR, float(pose[2, 3]),
                                         mask)
    return out


# --------------------------------------------------------------------------
# entry


def detect_format(root: str) -> str:
    """'lm6d' | 'ycb_video' | 'bop' by landmark files."""
    if os.path.isdir(os.path.join(root, "video_sets")):
        return "ycb_video"
    if os.path.isdir(os.path.join(root, "data", "observed")):
        return "lm6d"
    for split in ("test", "train", "val", "test_all", "train_pbr"):
        sd = os.path.join(root, split)
        if os.path.isdir(sd):
            for scene in os.listdir(sd):
                s = os.path.join(sd, scene)
                if (os.path.exists(os.path.join(s, "scene_gt.json"))
                        or os.path.exists(os.path.join(s, "gt.yml"))):
                    return f"bop:{split}"
    raise SystemExit(
        f"{root}: unrecognized layout — expected LM6d_converted "
        "(data/observed/), YCB-Video (video_sets/), or BOP/SIXD "
        "(<split>/<scene>/scene_gt.json|gt.yml)")


def validate(root: str, fmt: str = "auto", **kw) -> list[Finding]:
    if fmt == "auto":
        fmt = detect_format(root)
    if fmt == "lm6d":
        return validate_lm6d(root, **kw)
    if fmt == "ycb_video":
        return validate_ycb_video(root, **kw)
    if fmt.startswith("bop"):
        split = fmt.split(":", 1)[1] if ":" in fmt else "test"
        return validate_bop(root, split, **kw)
    raise ValueError(f"unknown format {fmt!r}")
