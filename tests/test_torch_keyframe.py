"""deepim_tpu_torch.data.video's keyframe protocol against deepim_tpu's (CPU).

The cases of tests/test_keyframe.py but ``convert_ycb_original`` (not
ported), on a YCB-style sequence the reference's ``gen_video`` writes and
both packages read:
- ``keyframes`` and ``keyframe_records``: the same rows and GT poses;
- ``iter_keyframe_batches`` with padding: frames and the per-sequence
  slot masks bit for bit the reference's (the port's batches converted by
  ``to_device``), the two objects' masks disjoint;
- each keyframe of a batch decoded once, not once an object, and the
  batch equal to the per-record ``load_keyframe``;
- ``apply_posecnn_mat_init`` on released-style ``.mat`` files
  (``scipy.io``): the same matches and init poses as the reference's;
  a missing results directory matches nothing.
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
