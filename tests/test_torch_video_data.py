"""deepim_tpu_torch.data.video, data.lm6d and the PLY IO against deepim_tpu (CPU).

- A sequence the port writes (``write_sequence``) loads in the reference's
  ``VideoDataset.load_sequence`` equal to the port's own load (frames,
  depths, labels, poses, class ids, windows), and a sequence the
  reference writes loads equal in both.
- ``LM6DDataset``'s writers: the reference's ``gt_roidb`` and
  ``load_frame`` read the model and frames the port wrote, at the same
  paths.
- ``load_ply(save_ply(m))`` round-trips, both packages read the port's
  file alike, and a textured PLY (UVs and a PNG texture) bakes alike.
- ``_render_frame`` against the reference's with its Pallas kernels in
  interpret mode, on the same poses: rgb and depth within the raster
  tolerance of ``tests/test_torch_scene.py``, labels equal off the
  pixels where the two objects' depths tie.
- ``gen_video`` on the CPU (2 objects, 3 frames, 1 occluder) writes a
  dataset both packages read, with its manifest last.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deepim_tpu.data import lm6d as lm6d_j
from deepim_tpu.data import video as video_j
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.raster import raster_xla
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu_torch.data import lm6d as lm6d_t
from deepim_tpu_torch.data import video as video_t
from deepim_tpu_torch.raster import mesh as mesh_t
from deepim_tpu_torch.raster import raster_ref
from deepim_tpu_torch.refine import refiner as ref_t
from test_torch_raster import _compare, _euler

SIZE = (48, 64)
K = np.array([[110.0, 0, 32.0], [0, 110.0, 24.0], [0, 0, 1]], np.float32)
OBJS = ["box", "torus", "icosphere"]


def _pose(ax, ay, az, t):
    return np.concatenate([_euler(ax, ay, az), np.asarray(t)[:, None]], 1).astype(np.float32)


def _sequence(seed, t=4, m=2, h=12, w=16):
    rng = np.random.RandomState(seed)
    return {
        "rgbs": rng.rand(t, h, w, 3).astype(np.float32),
        "depths": (rng.rand(t, h, w) * 2).astype(np.float32),
        "labels": rng.randint(0, m + 1, (t, h, w)).astype(np.uint8),
        "poses": np.stack([[_pose(*rng.uniform(-1, 1, 3), [0.0, 0.0, rng.uniform(0.5, 1)])
                            for _ in range(m)] for _ in range(t)]),
        "inits": np.stack([_pose(*rng.uniform(-1, 1, 3), [0.01, 0.0, 0.7]) for _ in range(m)]),
    }


def _assert_loads_equal(a, b):
    assert a["objects"] == b["objects"]
    for key in ("frames", "depths", "labels", "poses", "class_idx"):
        if a[key] is None or b[key] is None:
            assert a[key] is None and b[key] is None, key
            continue
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sequences_load_alike_in_both_packages(tmp_path, writer):
    s = _sequence(seed=1)
    root = str(tmp_path / "v")
    ds_t, ds_j = video_t.VideoDataset(root, OBJS), video_j.VideoDataset(root, OBJS)
    write = (ds_t if writer == "port" else ds_j).write_sequence
    fids = [f"{i:06d}" for i in range(4)]
    write("0000", fids, ["torus", "box"], s["rgbs"], s["depths"], s["poses"], s["inits"],
          labels=s["labels"])
    write("0001", fids[:2], ["icosphere"], s["rgbs"][:2], s["depths"][:2], s["poses"][:2, :1],
          s["inits"][:1])  # no label stream
    assert ds_t.sequences() == ds_j.sequences() == ["0000", "0001"]
    assert ds_t.frame_ids("0000") == fids and ds_t.objects_in("0000") == ["torus", "box"]
    np.testing.assert_array_equal(ds_t.init_poses("0000"), ds_j.init_poses("0000"))
    for kw in ({}, {"start": 1, "count": 2}, {"with_depths": False, "with_labels": False}):
        got, want = ds_t.load_sequence("0000", **kw), ds_j.load_sequence("0000", **kw)
        _assert_loads_equal(got, want)
    got = ds_t.load_sequence("0000")
    np.testing.assert_array_equal(got["labels"], s["labels"])
    np.testing.assert_array_equal(got["class_idx"], [1, 0])
    np.testing.assert_allclose(got["frames"], s["rgbs"], atol=1 / 255 + 1e-7)
    np.testing.assert_allclose(got["depths"], s["depths"], atol=1e-3)
    np.testing.assert_allclose(got["poses"], s["poses"], atol=1e-7)
    _assert_loads_equal(ds_t.load_sequence("0001"), ds_j.load_sequence("0001"))
    assert ds_t.load_sequence("0001")["labels"] is None
    assert ds_t.init_poses("nope") is None


def test_lm6d_writers_are_read_by_the_reference(tmp_path):
    root = str(tmp_path / "lm")
    ds = lm6d_t.LM6DDataset(root, ["box", "torus"])
    rng = np.random.RandomState(5)
    rgb, depth = rng.rand(12, 16, 3), rng.rand(12, 16).astype(np.float32)
    label = rng.randint(0, 3, (12, 16)).astype(np.uint8)
    pose = _pose(0.1, 0.2, 0.3, [0.0, 0.01, 0.8])
    ds.write_model("torus", mesh_t.torus_mesh())
    ds.write_frame("000001", "000007", rgb, depth, label, {"torus": pose})
    ds.write_frame("000001", "000008", rgb, depth, None, {"torus": pose})
    ref = lm6d_j.LM6DDataset(root, ["box", "torus"])
    ref.write_image_set("torus", "test", [("000001", "000007"), ("000001", "000008")])
    ref.write_init_poses("torus", "test", np.stack([pose, pose]))
    assert ref.model_path("torus") == ds.model_path("torus").replace(os.sep, "/")
    recs = ref.gt_roidb("torus", "test")
    assert [(r.scene, r.frame, r.class_idx) for r in recs] == [("000001", "000007", 1),
                                                               ("000001", "000008", 1)]
    np.testing.assert_allclose(recs[0].pose, pose, atol=1e-7)
    np.testing.assert_allclose(recs[1].init_pose, pose, atol=1e-7)
    frame = ref.load_frame(recs[0])
    np.testing.assert_allclose(frame["obs_rgb"], rgb, atol=1 / 255 + 1e-7)
    np.testing.assert_allclose(frame["obs_depth"], depth, atol=1e-3)
    np.testing.assert_array_equal(frame["obs_mask"], label == 2)
    np.testing.assert_array_equal(ref.load_frame(recs[1])["obs_mask"], frame["obs_depth"] > 0)
    assert ds._imageset_path("torus", "test") == ref._imageset_path("torus", "test")
    assert ds._ren("torus", "1", "2", 0, "c") == ref._ren("torus", "1", "2", 0, "c")
    m = mesh_j.load_ply(ds.model_path("torus"))
    np.testing.assert_array_equal(m.faces, mesh_t.torus_mesh().faces)


def test_ply_round_trip_and_cross_read(tmp_path):
    mesh = mesh_t.PROCEDURAL_MESHES["torus"]()
    path = str(tmp_path / "m.ply")
    mesh_t.save_ply(path, mesh)
    back = mesh_t.load_ply(path)
    np.testing.assert_array_equal(back.vertices, mesh.vertices)
    np.testing.assert_array_equal(back.faces, mesh.faces)
    np.testing.assert_allclose(back.colors, mesh.colors, atol=1 / 255 + 1e-7)
    ref = mesh_j.load_ply(path)
    for field in ("vertices", "faces", "colors", "normals"):
        np.testing.assert_array_equal(getattr(back, field), getattr(ref, field), err_msg=field)
    mesh_j.save_ply(str(tmp_path / "r.ply"), mesh)
    assert open(path).read() == open(tmp_path / "r.ply").read()


def test_binary_ply_reads_like_the_reference(tmp_path):
    rng = np.random.RandomState(8)
    v = rng.rand(5, 3).astype("<f4")
    c = (rng.rand(5, 3) * 255).astype(np.uint8)
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\nproperty float x\n"
            "property float y\nproperty float z\nproperty uchar red\nproperty uchar green\n"
            "property uchar blue\nelement face 2\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode()
    body = b"".join(p.tobytes() + q.tobytes() for p, q in zip(v, c))
    body += bytes([3]) + np.array([0, 1, 2], "<i4").tobytes()
    body += bytes([4]) + np.array([1, 2, 3, 4], "<i4").tobytes()
    (tmp_path / "b.ply").write_bytes(head + body)
    got, want = mesh_t.load_ply(str(tmp_path / "b.ply")), mesh_j.load_ply(str(tmp_path / "b.ply"))
    np.testing.assert_array_equal(got.faces, [[0, 1, 2], [1, 2, 3], [1, 3, 4]])
    for field in ("vertices", "faces", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_textured_ply_bakes_like_the_reference(tmp_path):
    rng = np.random.RandomState(7)
    tex = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
    Image.fromarray(tex).save(tmp_path / "tex.png")
    v = np.array([[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0], [0.1, 0.1, 0.02]], np.float32)
    uv = np.array([[0.1, 0.2], [0.9, 0.1], [0.3, 0.8], [0.7, 0.6]], np.float32)
    lines = ["ply", "format ascii 1.0", "comment TextureFile tex.png", "element vertex 4",
             "property float x", "property float y", "property float z",
             "property float texture_u", "property float texture_v", "element face 1",
             "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join(str(x) for x in (*p, *q)) for p, q in zip(v, uv)] + ["4 0 1 3 2"]
    (tmp_path / "t.ply").write_text("\n".join(lines) + "\n")
    got, want = mesh_t.load_ply(str(tmp_path / "t.ply")), mesh_j.load_ply(str(tmp_path / "t.ply"))
    assert got.faces.shape == (2, 3)
    for field in ("vertices", "faces", "colors", "normals", "uv", "texture"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_render_frame_matches_reference():
    meshes = [mesh_j.box_mesh((0.12, 0.1, 0.06)), mesh_j.torus_mesh()]
    at = ref_t.build_assets(meshes, num_points=16, device="cpu")
    aj = ref_j.build_assets(meshes, num_points=16)
    poses = np.stack([_pose(0.4, -0.3, 0.2, [0.02, 0.0, 0.62]),
                      _pose(1.1, 0.5, -0.4, [-0.01, 0.01, 0.55])])
    cls = np.array([0, 1], np.int32)
    amb, dif, d = 0.5, 0.6, (0.2, -0.3, -1.0)
    lit_t = raster_ref.Lighting(torch.tensor(amb), torch.tensor(dif), torch.tensor(d))
    lit_j = raster_xla.Lighting(jnp.float32(amb), jnp.float32(dif), jnp.asarray(d, jnp.float32))
    rgb_t, d_t, lab_t = video_t._render_frame(at, torch.from_numpy(cls), torch.from_numpy(poses),
                                              torch.from_numpy(K), SIZE, lit_t)
    rgb_j, d_j, lab_j = video_j._render_frame(aj, jnp.asarray(cls), jnp.asarray(poses),
                                              jnp.asarray(K), SIZE, "pallas_interpret", lit_j)
    _compare(rgb_t.numpy(), d_t.numpy(), np.asarray(rgb_j), np.asarray(d_j))
    lab_t, lab_j = lab_t.numpy(), np.asarray(lab_j)
    assert set(np.unique(lab_t)) == {0, 1, 2}  # both objects and background in view
    assert (lab_t == lab_j).mean() > 0.998
    np.testing.assert_array_equal(lab_t > 0, d_t.numpy() > 0)


def test_gen_video_writes_a_dataset_both_packages_read(tmp_path, capsys):
    root = str(tmp_path / "gen")
    meshes = {"box": mesh_t.PROCEDURAL_MESHES["box"](),
              "torus": mesh_t.PROCEDURAL_MESHES["torus"]()}
    ds = video_t.gen_video(root, meshes, K, SIZE, num_frames=3, seed=2, occluders=1,
                           device="cpu")
    assert "PNG write" in capsys.readouterr().out
    assert ds.sequences() == ["0000"]  # both objects in every frame
    assert video_t.read_manifest(root) == video_t.video_manifest(
        ["box", "torus"], K, SIZE, 3, seed=2, occluders=1)
    with open(os.path.join(root, video_t.MANIFEST)) as f:
        assert json.load(f)["objects"] == ["box", "torus"]
    ref = video_j.VideoDataset(root, ["box", "torus"])
    for seq in ds.sequences():
        got = ds.load_sequence(seq)
        _assert_loads_equal(got, ref.load_sequence(seq))
        assert got["frames"].shape == (3, *SIZE, 3) and got["poses"].shape == (3, 2, 3, 4)
        fg = got["depths"] > 0
        assert set(np.unique(got["labels"])) == {0, 1, 2}
        assert not ((got["labels"] > 0) & ~fg).any()
        assert ((got["labels"] == 0) & fg).any()  # the occluder: depth, no label
        assert np.isfinite(got["poses"]).all()
        assert not np.allclose(got["poses"][0], got["poses"][-1])  # the object moves
    for obj in meshes:
        m = mesh_t.load_ply(ds._frames.model_path(obj))
        np.testing.assert_array_equal(m.faces, meshes[obj].faces)
    # the same call draws the same sequences
    again = video_t.gen_video(str(tmp_path / "again"), meshes, K, SIZE, num_frames=3, seed=2,
                              occluders=1, device="cpu")
    _assert_loads_equal(again.load_sequence("0000"), ds.load_sequence("0000"))
