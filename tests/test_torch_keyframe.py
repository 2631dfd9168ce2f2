"""deepim_tpu_torch.data.video's keyframe protocol against deepim_tpu's (CPU).

The cases of tests/test_keyframe.py, on a YCB-style sequence the
reference's ``gen_video`` writes and both packages read:
- ``keyframes`` and ``keyframe_records``: the same rows and GT poses;
- ``iter_keyframe_batches`` with padding: frames and the per-sequence
  slot masks bit for bit the reference's (the port's batches converted by
  ``to_device``), the two objects' masks disjoint;
- each keyframe of a batch decoded once, not once an object, and the
  batch equal to the per-record ``load_keyframe``;
- ``apply_posecnn_mat_init`` on released-style ``.mat`` files
  (``scipy.io``): the same matches and init poses as the reference's;
  a missing results directory matches nothing;
- ``convert_ycb_original`` on the reference test's release fixture
  (``-meta.mat``, 1-based global class ids, ``factor_depth`` 10000, global
  labels, ``keyframe.txt`` with a foreign sequence, OBJ models): both
  packages write the same files (images decode equal, the port copying the
  colour PNGs' bytes where the reference re-encodes them; poses within
  rtol 1e-6), and the reference test's checks hold on the port's output;
  then a generated root laid out as the release converts back to it
  (poses within 1e-6 m, masks equal, RGB equal, depth within 1 mm).
"""

import os

import numpy as np
import pytest

from deepim_tpu.data import video as video_j
from deepim_tpu.raster.mesh import box_mesh, icosphere_mesh
from deepim_tpu_torch.data import lm6d as lm6d_t
from deepim_tpu_torch.data import video as video_t

K_CAM = np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]], np.float32)
H, W = 48, 64
OBJECTS = ["box", "icosphere"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ycbv"))
    ds = video_j.gen_video(root, {"box": box_mesh((0.3, 0.3, 0.06)),
                                  "icosphere": icosphere_mesh(0.05)},
                           K_CAM, (H, W), num_frames=6, num_sequences=1, seed=0)
    (seq,) = ds.sequences()
    video_t.VideoDataset(root, OBJECTS).write_keyframes(
        [(seq, fid) for fid in ds.frame_ids(seq)[::2]])
    return root


def _both(root):
    return video_t.VideoDataset(root, OBJECTS), video_j.VideoDataset(root, OBJECTS)


def test_keyframe_records(root):
    vt, vj = _both(root)
    assert vt.has_keyframes() and vt.keyframes() == vj.keyframes() and len(vt.keyframes()) == 3
    rt, rj = video_t.keyframe_records(vt), video_j.keyframe_records(vj)
    assert len(rt) == len(rj) == 6
    for a, b in zip(rt, rj):
        assert (a.scene, a.frame, a.obj, a.class_idx, a.init_pose) == (
            b.scene, b.frame, b.obj, b.class_idx, b.init_pose)
        np.testing.assert_array_equal(a.pose, b.pose)
    np.testing.assert_array_equal(rt[0].pose, vt.keyframe_pose(rt[0].scene, rt[0].frame,
                                                                rt[0].obj))


def test_keyframe_batches_and_masks(root):
    vt, vj = _both(root)
    rt, rj = video_t.keyframe_records(vt), video_j.keyframe_records(vj)
    bs = 4
    pad_to = (len(rt) + bs - 1) // bs * bs
    got = [lm6d_t.to_device(b, "cpu") for b in
           video_t.iter_keyframe_batches(vt, rt, bs, pad_to=pad_to)]
    want = list(video_j.iter_keyframe_batches(vj, rj, bs, pad_to=pad_to))
    assert len(got) == len(want) == pad_to // bs
    for b_t, b_j in zip(got, want):
        for key in ("obs_rgb", "obs_depth", "obs_mask"):
            np.testing.assert_array_equal(b_t[key].numpy(), b_j[key], err_msg=key)
    m_box, m_ico = got[0]["obs_mask"][0].numpy(), got[0]["obs_mask"][1].numpy()
    assert m_box.sum() > 0 and m_ico.sum() > 0 and not (m_box & m_ico).any()
    raw_t, raw_j = vt.load_frame_raw(rt[0].scene, rt[0].frame), vj.load_frame_raw(
        rt[0].scene, rt[0].frame)
    for key in raw_j:
        np.testing.assert_array_equal(raw_t[key], raw_j[key], err_msg=key)
        np.testing.assert_array_equal(vt.frame_mask(raw_t, rt[0].scene, "icosphere"),
                                      vj.frame_mask(raw_j, rt[0].scene, "icosphere"))


def test_keyframe_batches_decode_each_frame_once(root, monkeypatch):
    vt, _ = _both(root)
    recs = video_t.keyframe_records(vt)
    naive = [vt.load_keyframe(r.scene, r.frame, r.obj) for r in recs]
    calls = []
    orig = video_t.VideoDataset.load_frame_samples

    def counting(self, seq, frame):
        calls.append((seq, frame))
        return orig(self, seq, frame)

    monkeypatch.setattr(video_t.VideoDataset, "load_frame_samples", counting)
    (batch,) = [lm6d_t.to_device(b, "cpu")
                for b in video_t.iter_keyframe_batches(vt, recs, len(recs))]
    assert len(calls) == len({(r.scene, r.frame) for r in recs}) == 3 < len(recs)
    for i, f in enumerate(naive):
        for key in ("obs_rgb", "obs_depth", "obs_mask"):
            np.testing.assert_array_equal(batch[key][i].numpy(), f[key], err_msg=key)


def test_posecnn_mat_import(root, tmp_path):
    scipy_io = pytest.importorskip("scipy.io")
    vt, vj = _both(root)
    rt, rj = video_t.keyframe_records(vt), video_j.keyframe_records(vj)
    results = tmp_path / "posecnn"
    os.makedirs(results)
    rng = np.random.RandomState(0)
    for ki, (seq, fid) in enumerate(vt.keyframes()):
        rois, poses = [], []
        for obj in vt.objects_in(seq):
            gt = vt.keyframe_pose(seq, fid, obj)
            q = rng.randn(4)  # any quaternion: both packages normalise it
            rois.append([0, vt.class_to_idx[obj] + 1, 0, 0, 0, 0, 0.9])
            poses.append(np.concatenate([q, gt[:, 3] + np.float32([0.01, 0.0, 0.02])]))
        scipy_io.savemat(str(results / f"{ki:06d}.mat"),
                         {"rois": np.asarray(rois, np.float32),
                          "poses": np.asarray(poses, np.float32)})
    init_t = np.stack([r.pose for r in rt]).copy()
    init_j = init_t.copy()
    assert video_t.apply_posecnn_mat_init(rt, init_t, str(results)) == len(rt)
    assert video_j.apply_posecnn_mat_init(rj, init_j, str(results)) == len(rj)
    np.testing.assert_array_equal(init_t, init_j)
    np.testing.assert_allclose(init_t[:, :, :3] @ init_t[:, :, :3].transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (len(rt), 3, 3)), atol=1e-5)
    # obj_ids map class_idx to the release's ids: a map naming others matches none
    assert video_t.apply_posecnn_mat_init(rt, init_t.copy(), str(results), obj_ids=[7, 9]) == 0
    assert video_t.apply_posecnn_mat_init(rt, init_t.copy(), str(tmp_path / "nope")) == 0


def _write_ycb_original(src):
    """The fixture of tests/test_keyframe.py §test_convert_ycb_original."""
    from PIL import Image
    from scipy import io as scipy_io

    rng = np.random.RandomState(0)
    seq, fids = "0003", ["000001", "000002"]
    sdir = os.path.join(src, "data", seq)
    os.makedirs(sdir)
    cls_indexes = np.asarray([[2], [3]], np.uint8)  # beta (2) and gamma (3), 1-based
    gt = {}
    for fid in fids:
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
            os.path.join(sdir, f"{fid}-color.png"))
        depth_m = rng.rand(48, 64).astype(np.float32)
        Image.fromarray((depth_m * 10000).astype(np.uint16)).save(
            os.path.join(sdir, f"{fid}-depth.png"))
        lab = np.zeros((48, 64), np.uint8)
        lab[:10, :10] = 2  # global class id of beta
        lab[20:30, :10] = 3  # gamma
        Image.fromarray(lab).save(os.path.join(sdir, f"{fid}-label.png"))
        poses = rng.randn(3, 4, 2).astype(np.float32)
        scipy_io.savemat(os.path.join(sdir, f"{fid}-meta.mat"),
                         {"poses": poses, "cls_indexes": cls_indexes,
                          "factor_depth": np.asarray([[10000.0]]),
                          "intrinsic_matrix": np.eye(3)})
        gt[fid] = (poses, depth_m)
    for name in ("beta", "gamma"):
        mdir = os.path.join(src, "models", name)
        os.makedirs(mdir)
        with open(os.path.join(mdir, "textured.obj"), "w") as f:
            f.write("v 0 0 0\nv 0.1 0 0\nv 0 0.1 0\nf 1 2 3\n")
    os.makedirs(os.path.join(src, "image_sets"))
    with open(os.path.join(src, "image_sets", "keyframe.txt"), "w") as f:
        f.write(f"{seq}/{fids[1]}\n0099/000777\n")  # one outside the sequences
    return seq, fids, gt


def test_convert_ycb_original(tmp_path):
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_release_fixtures import assert_trees_match

    classes = ["alpha", "beta", "gamma"]
    src = str(tmp_path / "ycb_src")
    seq, fids, gt = _write_ycb_original(src)
    out_j, out = str(tmp_path / "ycb_video_j"), str(tmp_path / "ycb_video")
    video_j.convert_ycb_original(src, out_j, classes)
    ds = video_t.convert_ycb_original(src, out, classes)
    assert assert_trees_match(out_j, out) > 0
    assert ds.objects_in(seq) == ["beta", "gamma"]
    assert ds.keyframes() == [(seq, fids[1])]  # the foreign sequence filtered
    np.testing.assert_allclose(ds.keyframe_pose(seq, fids[0], "beta"), gt[fids[0]][0][:, :, 0],
                               atol=1e-6)
    frame = ds.load_keyframe(seq, fids[0], "gamma")
    np.testing.assert_allclose(frame["obs_depth"], gt[fids[0]][1], atol=2e-3)  # uint16 mm
    assert frame["obs_mask"][20:30, :10].all()  # gamma (global 3) is slot 2
    assert not frame["obs_mask"][:10, :10].any()
    with open(os.path.join(src, "data", seq, f"{fids[0]}-color.png"), "rb") as f:
        src_bytes = f.read()
    with open(ds._vid(seq, fids[0], "color.png"), "rb") as f:
        assert f.read() == src_bytes  # copied, not re-encoded
    m1, m2 = lm6d_t.LM6DDataset(out, ["beta", "gamma"]).load_meshes()
    assert m1.num_faces == 1 and m2.num_faces == 1


def test_convert_ycb_original_release_fixture(tmp_path):
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_release_fixtures import (
        _generated, assert_trees_match, compare_ycb, write_ycb_original_release)

    gen = _generated(tmp_path, OBJECTS)
    src = str(tmp_path / "ycb_release")
    classes = write_ycb_original_release(gen, OBJECTS, src, K_CAM)
    out_j, out = str(tmp_path / "out_j"), str(tmp_path / "out_t")
    video_j.convert_ycb_original(src, out_j, classes)
    ds = video_t.convert_ycb_original(src, out, classes)
    assert_trees_match(out_j, out)
    d = compare_ycb(gen, out, OBJECTS)
    assert d["frames"] == 6 and d["labels_equal"] and d["rgb_equal"], d
    assert d["pose_max_abs"] <= 1e-6 and d["depth_max_mm"] <= 1, d
    assert ds.keyframes() == [("0000", "000000"), ("0000", "000002"), ("0001", "000000"),
                              ("0001", "000002")]
