"""deepim_tpu_torch.data.lm6d against deepim_tpu.data.lm6d (CPU).

- A root written by the reference's toolkit, read by both packages: equal
  records (scenes, frames, GT and init poses), frames (``load_frame``),
  ``make_eval_arrays`` and ``iter_frame_batches`` with padding, through
  ``prefetch_iter`` (the port's batches converted by ``to_device``), bit
  for bit.
- A root written by the port's toolkit, read by the reference: the same.
- ``prefetch_iter`` and ``TrainBatcher`` re-raise a worker's exception
  with its cause chained; ``TrainBatcher``'s batches over two epochs are
  the reference's, record for record and pixel for pixel.
- ``apply_bop_init``'s three cases of tests/test_eval_data.py:489-566 on
  both packages, the same matches and init poses.
- ``to_device``'s conversion of every uint8 and uint16 sample equals the
  reference's ``astype(np.float32) / x``; unpinned host batches never share
  memory.
"""

import numpy as np
import pytest
import torch

from deepim_tpu.data import lm6d as lm6d_j
from deepim_tpu.data.toolkit import gen_procedural_dataset as gen_j
from deepim_tpu.eval import write_bop_csv
from deepim_tpu_torch.data import lm6d as lm6d_t
from deepim_tpu_torch.data.toolkit import gen_procedural_dataset as gen_t

K_CAM = np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]], np.float32)
H, W = 48, 64
OBJECTS = ["box", "icosphere"]


@pytest.fixture(scope="module")
def ref_root(tmp_path_factory):
    return gen_j(str(tmp_path_factory.mktemp("lm6d_ref")), OBJECTS, K_CAM, (H, W),
                 frames_per_obj=6, seed=0).root


@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    return gen_t(str(tmp_path_factory.mktemp("lm6d_port")), OBJECTS, K_CAM, (H, W),
                 frames_per_obj=6, seed=0, device="cpu").root


def _records(root):
    dt, dj = lm6d_t.LM6DDataset(root, OBJECTS), lm6d_j.LM6DDataset(root, OBJECTS)
    rt = [r for o in OBJECTS for s in ("train", "test") for r in dt.gt_roidb(o, s)]
    rj = [r for o in OBJECTS for s in ("train", "test") for r in dj.gt_roidb(o, s)]
    return dt, dj, rt, rj


def _assert_records_equal(rt, rj):
    assert len(rt) == len(rj) > 0
    for a, b in zip(rt, rj):
        assert (a.scene, a.frame, a.obj, a.class_idx) == (b.scene, b.frame, b.obj, b.class_idx)
        np.testing.assert_array_equal(a.pose, b.pose)
        np.testing.assert_array_equal(a.init_pose, b.init_pose)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_both_packages_read_the_same_root(ref_root, port_root, writer):
    root = ref_root if writer == "reference" else port_root
    dt, dj, rt, rj = _records(root)
    _assert_records_equal(rt, rj)
    assert lm6d_t.LM6DDataset.discover_objects(root) == lm6d_j.LM6DDataset.discover_objects(root)
    for a, b in zip(rt, rj):
        ft, fj = dt.load_frame(a), dj.load_frame(b)
        for key in ("obs_rgb", "obs_depth", "obs_mask"):
            assert ft[key].dtype == fj[key].dtype, key
            np.testing.assert_array_equal(ft[key], fj[key], err_msg=key)
    assert rt[0].init_pose is not None and dt.load_frame(rt[0])["obs_mask"].any()


def test_eval_arrays_and_streamed_batches_with_padding(ref_root):
    dt, dj, _, _ = _records(ref_root)
    rt = dt.gt_roidb("box", "test") + dt.gt_roidb("icosphere", "test")
    rj = dj.gt_roidb("box", "test") + dj.gt_roidb("icosphere", "test")
    bs = 3
    pad_to = (len(rt) + bs - 1) // bs * bs + bs  # at least one padded row
    whole_t = lm6d_t.make_eval_arrays(dt, rt, pad_to=pad_to)
    whole_j = lm6d_j.make_eval_arrays(dj, rj, pad_to=pad_to)
    assert whole_t["num_real"] == whole_j["num_real"] == len(rt)
    for key, want in whole_j.items():
        np.testing.assert_array_equal(whole_t[key], want, err_msg=key)
    got = [lm6d_t.to_device(b, "cpu") for b in
           lm6d_t.prefetch_iter(lm6d_t.iter_frame_batches(dt, rt, bs, pad_to=pad_to))]
    want = list(lm6d_j.prefetch_iter(lm6d_j.iter_frame_batches(dj, rj, bs, pad_to=pad_to)))
    assert len(got) == len(want) == pad_to // bs
    for b_t, b_j in zip(got, want):
        for key in ("obs_rgb", "obs_depth", "obs_mask"):
            assert b_t[key].numpy().dtype == b_j[key].dtype, key
            np.testing.assert_array_equal(b_t[key].numpy(), b_j[key], err_msg=key)
    with pytest.raises(ValueError, match="multiple"):
        next(lm6d_t.iter_frame_batches(dt, rt, bs, pad_to=pad_to + 1))


def test_prefetch_iter_chains_worker_errors():
    def bad():
        yield 1
        raise ValueError("boom")

    it = lm6d_t.prefetch_iter(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="prefetch worker failed") as err:
        next(it)
    assert isinstance(err.value.__cause__, ValueError)


def test_train_batcher_is_the_references_record_for_record(ref_root):
    dt, dj, _, _ = _records(ref_root)
    bt = lm6d_t.TrainBatcher(dt, OBJECTS, batch_size=4, seed=1)
    bj = lm6d_j.TrainBatcher(dj, OBJECTS, batch_size=4, seed=1)
    assert bt.num_records == bj.num_records
    for _ in range(2 * bt.num_records // 4 + 1):  # two epochs and a batch
        got, want = lm6d_t.to_device(bt.next(), "cpu"), bj.next()
        np.testing.assert_array_equal(got["pose_tgt"].numpy(), want["pose_tgt"])
        np.testing.assert_array_equal(got["class_idx"].numpy(), want["class_idx"])
        np.testing.assert_array_equal(got["obs_rgb"].numpy(), want["obs_rgb"])
        np.testing.assert_array_equal(got["obs_depth"].numpy(), want["obs_depth"])
        np.testing.assert_array_equal(got["obs_mask"].numpy().astype(np.float32),
                                      want["obs_mask"])
        assert got["obs_mask"].dtype == torch.bool


def test_train_batcher_reraises_and_stays_usable(ref_root, monkeypatch):
    dt = lm6d_t.LM6DDataset(ref_root, OBJECTS)
    real = dt.load_frame_raw
    calls = []

    def flaky(rec):
        calls.append(rec)
        if len(calls) == 1:
            raise OSError("corrupt PNG")
        return real(rec)

    monkeypatch.setattr(dt, "load_frame_raw", flaky)
    b = lm6d_t.TrainBatcher(dt, OBJECTS, batch_size=2, seed=0)
    with pytest.raises(RuntimeError, match="TrainBatcher prefetch worker failed") as err:
        b.next()
    assert isinstance(err.value.__cause__, OSError)
    assert b.next()["obs_rgb"].shape == (2, H, W, 3)


def _pose(rx=0.0, tz=0.7):
    c, s = np.cos(rx), np.sin(rx)
    r = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    return np.concatenate([r, [[0.0], [0.0], [tz]]], 1)


@pytest.mark.parametrize("case", ["matched", "obj_ids", "best_score"])
def test_apply_bop_init_matches_reference(ref_root, tmp_path, case):
    dt, dj, _, _ = _records(ref_root)
    rt = dt.gt_roidb("box", "test") + dt.gt_roidb("icosphere", "test")
    rj = dj.gt_roidb("box", "test") + dj.gt_roidb("icosphere", "test")
    path = str(tmp_path / "init.csv")
    kw = {}
    if case == "matched":
        targets = [rt[0], rt[-1]]
        write_bop_csv(path, np.stack([_pose(0.5, 0.9), _pose(-0.2, 0.5)]),
                      obj_ids=np.array([r.class_idx + 1 for r in targets]),
                      scene_ids=np.array([int(r.scene) for r in targets]),
                      im_ids=np.array([int(r.frame) for r in targets]))
    elif case == "obj_ids":
        rt, rj = rt[:2], rj[:2]
        write_bop_csv(path, np.stack([_pose(0.5, 0.9), _pose(-0.2, 0.5)]),
                      obj_ids=np.array([8, 8]),
                      scene_ids=np.array([int(r.scene) for r in rt]),
                      im_ids=np.array([int(r.frame) for r in rt]))
        kw = {"obj_ids": [8, 11]}
    else:
        rt, rj = rt[:1], rj[:1]
        write_bop_csv(path, np.stack([_pose(0.5, 0.9), _pose(-0.9, 0.4)]),
                      obj_ids=np.array([1, 1]), scene_ids=np.array([int(rt[0].scene)] * 2),
                      im_ids=np.array([int(rt[0].frame)] * 2), scores=np.array([0.9, 0.1]))
    init_t = np.stack([r.pose for r in rt]).astype(np.float32)
    init_j = init_t.copy()
    n_t = lm6d_t.apply_bop_init(rt, init_t, path, **kw)
    n_j = lm6d_j.apply_bop_init(rj, init_j, path, **kw)
    assert n_t == n_j == {"matched": 2, "obj_ids": 2, "best_score": 1}[case]
    np.testing.assert_array_equal(init_t, init_j)
    if case == "obj_ids":
        assert lm6d_t.apply_bop_init(rt, init_t.copy(), path) == 0  # positional ids miss
        with pytest.raises(ValueError, match="obj_ids"):
            lm6d_t.apply_bop_init(rt, init_t.copy(), path, obj_ids=[])


def test_to_device_converts_as_the_reference_does():
    u8 = np.arange(256, dtype=np.uint8)
    u16 = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    got = lm6d_t.to_device({"obs_rgb": torch.from_numpy(u8),
                            "obs_depth": torch.from_numpy(u16.view(np.int16)),
                            "pose_tgt": torch.zeros(1, 3, 4), "_copied": None}, "cpu")
    np.testing.assert_array_equal(got["obs_rgb"].numpy(), u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got["obs_depth"].numpy(),
                                  u16.astype(np.float32) / lm6d_j.DEPTH_FACTOR)
    assert set(got) == {"obs_rgb", "obs_depth", "pose_tgt"}


def test_unpinned_batches_do_not_share_memory(ref_root):
    dt = lm6d_t.LM6DDataset(ref_root, OBJECTS)
    recs = dt.gt_roidb("box", "train")
    a, b = list(lm6d_t.iter_frame_batches(dt, recs[:4], 2, pin_memory=False))
    assert a["obs_rgb"].data_ptr() != b["obs_rgb"].data_ptr()
    assert not a["obs_rgb"].is_pinned()
