"""deepim_tpu_torch.data.toolkit against deepim_tpu.data.toolkit (CPU).

- ``gen_procedural_dataset`` writes the reference's layout: the same files,
  models byte for byte, the same split sizes and frame order (the split
  permutation is the reference's ``RandomState(seed)``); only the drawn
  poses differ (torch generators, not JAX keys).
- The toolkit's render (``render_crops``: the sorted kernel's plain version
  here, with C.2's 128-face global cap) of shared poses against the
  reference's lossless XLA oracle: within the repo's raster tolerance
  (at most 0.2 % of RGB pixels off by more than 2e-2 and of depth pixels
  by more than 1 mm), and no missing face (at most 0.2 % of the oracle's
  covered pixels uncovered).
- ``gen_rendered``'s views read back alike in both packages, perturbed from
  GT and consistent with their source pose.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.data import lm6d as lm6d_j
from deepim_tpu.data.toolkit import gen_procedural_dataset as gen_j
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu_torch.data import lm6d as lm6d_t
from deepim_tpu_torch.data import toolkit as tk_t
from deepim_tpu_torch.data.pairs import sample_poses_in_frustum
from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES
from deepim_tpu_torch.refine import build_assets
from test_torch_raster import _compare

K_CAM = np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]], np.float32)
H, W = 48, 64
OBJECTS = ["box", "icosphere"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_layout_and_splits_equal_the_reference(tmp_path, capsys):
    rt = tk_t.gen_procedural_dataset(str(tmp_path / "t"), OBJECTS, K_CAM, (H, W),
                                     frames_per_obj=5, seed=3, device="cpu").root
    assert "render" in capsys.readouterr().out
    rj = gen_j(str(tmp_path / "j"), OBJECTS, K_CAM, (H, W), frames_per_obj=5, seed=3).root
    assert _files(rt) == _files(rj)
    for f in _files(rt):
        if f.startswith(("models", "image_set")):
            assert open(os.path.join(rt, f), "rb").read() == open(os.path.join(rj, f), "rb").read()
    for obj in OBJECTS:
        # round(0.7 * 5) = 4 train frames leave 1 of the 2 the test split asks for
        for split, n in (("train", 4), ("test", 1)):
            a = np.loadtxt(os.path.join(rt, "init_poses", f"{obj}_{split}.txt")).reshape(-1, 12)
            b = np.loadtxt(os.path.join(rj, "init_poses", f"{obj}_{split}.txt")).reshape(-1, 12)
            assert a.shape == b.shape == (n, 12)
    # a frame's label marks its object's pixels, and its depth is metric
    ds = lm6d_t.LM6DDataset(rt, OBJECTS)
    rec = ds.gt_roidb("icosphere", "test")[0]
    frame = ds.load_frame(rec)
    assert frame["obs_mask"].any() and abs(
        float(np.median(frame["obs_depth"][frame["obs_mask"]])) - rec.pose[2, 3]) < 0.06


@pytest.mark.parametrize("obj", ["box", "icosphere", "cylinder", "torus"])
def test_render_matches_the_reference_oracle(obj):
    meshes = [PROCEDURAL_MESHES[o]() for o in ("box", "icosphere", "cylinder", "torus")]
    ci = ["box", "icosphere", "cylinder", "torus"].index(obj)
    size, k = (72, 96), np.array([[220.0, 0, 48], [0, 220.0, 36], [0, 0, 1]], np.float32)
    poses = sample_poses_in_frustum(torch.Generator().manual_seed(ci), 3, torch.from_numpy(k),
                                    size, z_range=(0.5, 1.4))
    at = build_assets(meshes, num_points=256, device="cpu")
    rgb_t, d_t = tk_t.render_frames(at, ci, poses, torch.from_numpy(k), size)
    aj = ref_j.build_assets(meshes, num_points=256)
    ab = ref_j.gather_class(aj, jnp.full((3,), ci, jnp.int32))
    rgb_j, d_j = ref_j.render_crops(ab, jnp.asarray(poses.numpy()),
                                    jnp.tile(jnp.asarray(k)[None], (3, 1, 1)), size,
                                    renderer="xla")
    rgb_j, d_j = np.asarray(rgb_j), np.asarray(d_j)
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)
    missing = ((d_j > 0) & (d_t.numpy() == 0)).sum() / (d_j > 0).sum()
    assert missing <= 0.002, f"{missing:.4f} of the oracle's pixels uncovered"


def test_gen_rendered_round_trip(tmp_path):
    root = tk_t.gen_procedural_dataset(str(tmp_path / "r"), OBJECTS, K_CAM, (H, W),
                                       frames_per_obj=4, seed=0, device="cpu").root
    ds = lm6d_t.LM6DDataset(root, OBJECTS)
    meshes = {n: PROCEDURAL_MESHES[n]() for n in OBJECTS}
    n = tk_t.gen_rendered(ds, meshes, K_CAM, (H, W), split="train", per_frame=2, seed=1,
                          device="cpu")
    recs = [r for o in OBJECTS for r in ds.gt_roidb(o, "train")]
    assert n == 2 * len(recs)
    dj = lm6d_j.LM6DDataset(root, OBJECTS)
    for rec in recs:
        assert ds.has_rendered(rec, 1) and dj.has_rendered(rec, 1)
        got, want = ds.load_rendered(rec, 1), dj.load_rendered(rec, 1)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        mask = got["ren_depth"] > 0
        assert np.abs(got["pose_src"] - rec.pose).max() > 1e-4
        assert mask.any() and abs(float(np.median(got["ren_depth"][mask]))
                                  - got["pose_src"][2, 3]) < 0.12
