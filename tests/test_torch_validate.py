"""deepim_tpu_torch.data.validate against deepim_tpu.data.validate (CPU).

The 23 cases of ``tests/test_validate_dataset.py``: drops that break each
real-world convention (depth factors, mm and cm poses, world-to-camera
and reflected rotations, mm meshes, label ids, missing frames, BOP keys
and units, YCB-Video slots and keyframes).  Each is checked by both
packages' validators on the same files: the port flags what the reference
test asks for, and its findings equal the reference's, record for record
(level, code, path, message); ``format_findings`` gives the same text.
The drops are written by the reference's generators, as its test writes
them, so each mutation breaks what that test's mutation breaks.
"""

import json
import os
import shutil

import numpy as np
import pytest

from deepim_tpu.data import validate as val_j
from deepim_tpu.data.toolkit import gen_procedural_dataset
from deepim_tpu_torch.data import validate as val_t
from deepim_tpu_torch.data.lm6d import LM6DDataset
from deepim_tpu_torch.data.png import read_png, write_png

K_CAM = np.array([[120.0, 0, 64], [0, 120.0, 32], [0, 0, 1]], np.float32)
H, W = 64, 128
OBJECTS = ["box", "icosphere"]


def _rec(f):
    return (f.level, f.code, f.path, f.message)


def _same(fn: str, *args, **kw):
    """The port's findings of ``validate.<fn>(*args)``, held equal to the
    reference's record for record."""
    got = getattr(val_t, fn)(*args, **kw)
    want = getattr(val_j, fn)(*args, **kw)
    assert [_rec(f) for f in got] == [_rec(f) for f in want]
    assert val_t.format_findings(got) == val_j.format_findings(want)
    return got


def _codes(findings):
    return {f.code for f in findings}


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lm6d_good"))
    gen_procedural_dataset(root, OBJECTS, K_CAM, (H, W), frames_per_obj=3, seed=0)
    return root


@pytest.fixture()
def lm6d_root(pristine, tmp_path):
    dst = str(tmp_path / "lm6d")
    shutil.copytree(pristine, dst)
    return dst


def _first_record(root):
    ds = LM6DDataset(root, OBJECTS)
    return ds, ds.gt_roidb("box", "test")[0]


def test_good_lm6d_passes(pristine):
    findings = _same("validate_lm6d", pristine, OBJECTS)
    assert not [f for f in findings if f.level == "ERROR"], val_t.format_findings(findings)


def test_detect_format(pristine, tmp_path):
    assert val_t.detect_format(pristine) == "lm6d"
    bop = tmp_path / "bop" / "test" / "000001"
    bop.mkdir(parents=True)
    (bop / "scene_gt.json").write_text("{}")
    assert val_t.detect_format(str(tmp_path / "bop")) == "bop:test"
    with pytest.raises(SystemExit):
        val_t.detect_format(str(tmp_path))


def _write_pose(ds, rec, pose):
    np.savetxt(ds._obs(rec.scene, rec.frame, "pose_box.txt"), pose)


def test_mm_translation_flagged(lm6d_root):
    ds, rec = _first_record(lm6d_root)
    bad = rec.pose.copy()
    bad[:, 3] *= 1000.0
    _write_pose(ds, rec, bad)
    assert "pose-translation-units" in _codes(_same("validate_lm6d", lm6d_root, OBJECTS))


def test_w2c_pose_flagged(lm6d_root):
    ds, rec = _first_record(lm6d_root)
    r, t = rec.pose[:, :3], rec.pose[:, 3]
    _write_pose(ds, rec, np.concatenate([r.T, (-r.T @ t)[:, None]], axis=1))
    assert "pose-behind-camera" in _codes(_same("validate_lm6d", lm6d_root, OBJECTS))


def test_nonorthonormal_rotation_flagged(lm6d_root):
    ds, rec = _first_record(lm6d_root)
    bad = rec.pose.copy()
    bad[:, :3] *= 1.2
    _write_pose(ds, rec, bad)
    assert "pose-rotation-not-orthonormal" in _codes(
        _same("validate_lm6d", lm6d_root, OBJECTS))


def test_reflected_rotation_flagged(lm6d_root):
    ds, rec = _first_record(lm6d_root)
    bad = rec.pose.copy()
    bad[1, :3] *= -1.0
    _write_pose(ds, rec, bad)
    assert "pose-rotation-reflected" in _codes(_same("validate_lm6d", lm6d_root, OBJECTS))


def test_check_pose_accepts_healthy():
    pose = np.concatenate([np.eye(3), [[0.02], [-0.01], [0.7]]], axis=1)
    assert val_t.check_pose(pose, "mem") == [] == val_j.check_pose(pose, "mem")


def test_wrong_depth_factor_flagged(lm6d_root):
    ds, rec = _first_record(lm6d_root)
    dpath = ds._obs(rec.scene, rec.frame, "depth.png")
    raw = read_png(dpath).astype(np.float64)
    write_png(dpath, np.clip(raw * 10.0, 0, 65535).astype(np.uint16))
    codes = _codes(_same("validate_lm6d", lm6d_root, OBJECTS))
    assert codes & {"depth-factor", "depth-pose-mismatch"}, codes


def test_missing_frame_flagged(lm6d_root):
    with open(os.path.join(lm6d_root, "image_set", "observed", "box_test.txt"), "a") as f:
        f.write("scene_99/999999\n")
    assert "frame-missing" in _codes(
        _same("validate_lm6d", lm6d_root, OBJECTS, max_frames_per_obj=10))


def test_init_pose_count_mismatch_flagged(lm6d_root):
    ds, rec = _first_record(lm6d_root)
    ds.write_init_poses("box", "test", np.tile(rec.pose[None], (7, 1, 1)))
    assert "init-poses-count" in _codes(_same("validate_lm6d", lm6d_root, OBJECTS))


def test_label_id_out_of_range_flagged(lm6d_root):
    ds, rec = _first_record(lm6d_root)
    lpath = ds._obs(rec.scene, rec.frame, "label.png")
    label = read_png(lpath).copy()
    label[:4, :4] = 200
    write_png(lpath, label)
    assert "label-id-range" in _codes(_same("validate_lm6d", lm6d_root, OBJECTS))


def test_mm_mesh_flagged(lm6d_root):
    from deepim_tpu_torch.raster.mesh import Mesh, load_ply, save_ply

    ds = LM6DDataset(lm6d_root, OBJECTS)
    mesh = load_ply(ds.model_path("box"))
    save_ply(ds.model_path("box"),
             Mesh(mesh.vertices * 1000.0, mesh.faces, mesh.colors, mesh.normals))
    assert "mesh-units-mm" in _codes(_same("validate_lm6d", lm6d_root, OBJECTS))


# -- BOP/SIXD source trees --------------------------------------------------


def _write_bop_scene(root, scene="000001", gt_entry=None, cam=None, with_rgb=True):
    sdir = os.path.join(root, "test", scene)
    os.makedirs(os.path.join(sdir, "rgb"), exist_ok=True)
    if with_rgb:
        write_png(os.path.join(sdir, "rgb", "000000.png"), np.zeros((H, W, 3), np.uint8))
    gt_entry = gt_entry if gt_entry is not None else {
        "cam_R_m2c": np.eye(3).reshape(-1).tolist(), "cam_t_m2c": [20.0, -10.0, 700.0],
        "obj_id": 1}
    cam = cam if cam is not None else {"cam_K": K_CAM.reshape(-1).tolist(), "depth_scale": 1.0}
    with open(os.path.join(sdir, "scene_gt.json"), "w") as f:
        json.dump({"0": [gt_entry]}, f)
    with open(os.path.join(sdir, "scene_camera.json"), "w") as f:
        json.dump({"0": cam}, f)
    return root


def test_bop_healthy_passes(tmp_path):
    findings = _same("validate_bop", _write_bop_scene(str(tmp_path)), "test")
    assert not [f for f in findings if f.level == "ERROR"], val_t.format_findings(findings)


def test_bop_w2c_key_flagged(tmp_path):
    root = _write_bop_scene(str(tmp_path), gt_entry={
        "cam_R_w2c": np.eye(3).reshape(-1).tolist(), "cam_t_w2c": [0.0, 0.0, 700.0],
        "obj_id": 1})
    assert "pose-w2c" in _codes(_same("validate_bop", root, "test"))


def test_bop_meter_translation_flagged(tmp_path):
    root = _write_bop_scene(str(tmp_path), gt_entry={
        "cam_R_m2c": np.eye(3).reshape(-1).tolist(), "cam_t_m2c": [0.02, -0.01, 0.7],
        "obj_id": 1})
    assert "bop-t-meters" in _codes(_same("validate_bop", root, "test"))


def test_bop_bad_depth_scale_flagged(tmp_path):
    root = _write_bop_scene(str(tmp_path), cam={"cam_K": K_CAM.reshape(-1).tolist(),
                                                 "depth_scale": 1000.0})
    assert "depth-scale" in _codes(_same("validate_bop", root, "test"))


def test_bop_missing_rgb_flagged(tmp_path):
    root = _write_bop_scene(str(tmp_path), with_rgb=False)
    assert "rgb-missing" in _codes(_same("validate_bop", root, "test"))


def test_bop_bad_cam_k_flagged(tmp_path):
    root = _write_bop_scene(str(tmp_path), cam={"cam_K": [1, 2, 3], "depth_scale": 1.0})
    assert "cam-k-shape" in _codes(_same("validate_bop", root, "test"))


# -- YCB-Video layout -------------------------------------------------------


@pytest.fixture()
def ycb_root(tmp_path):
    from deepim_tpu.data.video import gen_video
    from deepim_tpu.raster.mesh import box_mesh, icosphere_mesh

    root = str(tmp_path / "ycbv")
    ds = gen_video(root, {"box": box_mesh((0.3, 0.3, 0.06)), "icosphere": icosphere_mesh(0.05)},
                   K_CAM, (H, W), num_frames=4, num_sequences=1, seed=0)
    ds.write_keyframes([(s, fid) for s in ds.sequences() for fid in ds.frame_ids(s)[::2]])
    return root


def test_ycb_healthy_passes(ycb_root):
    findings = _same("validate_ycb_video", ycb_root)
    assert not [f for f in findings if f.level == "ERROR"], val_t.format_findings(findings)


def test_ycb_global_label_ids_flagged(ycb_root):
    from deepim_tpu_torch.data.video import VideoDataset

    ds = VideoDataset(ycb_root, OBJECTS)
    seq, fid = ds.keyframes()[0]
    lpath = ds._vid(seq, fid, "label.png")
    label = read_png(lpath).copy()
    label[:4, :4] = 15  # a global YCB class id; this sequence has 2 slots
    write_png(lpath, label)
    assert "label-slot-range" in _codes(_same("validate_ycb_video", ycb_root))


def test_ycb_keyframe_unknown_sequence_flagged(ycb_root):
    with open(os.path.join(ycb_root, "video_sets", "keyframe.txt"), "a") as f:
        f.write("9999/000042\n")
    assert "keyframe-unknown-seq" in _codes(_same("validate_ycb_video", ycb_root))


def test_sequences_excludes_keyframe_list(ycb_root):
    from deepim_tpu_torch.data.video import VideoDataset

    assert "keyframe" not in VideoDataset(ycb_root, OBJECTS).sequences()


# -- CLI --------------------------------------------------------------------


def test_cli_validate_dataset(pristine, capsys):
    from deepim_tpu_torch.cli import validate_dataset

    rc = validate_dataset.main([pristine])
    out = capsys.readouterr().out
    assert rc == 0 and "lm6d" in out and "OK" in out
