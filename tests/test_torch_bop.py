"""deepim_tpu_torch.data.bop against deepim_tpu.data.bop (CPU).

The two round trips of ``tests/test_bop_texture.py`` (a BOP JSON scene and
a SIXD YAML one, written with PIL in mm with ``depth_scale`` 0.1): both
packages convert the same release, and the outputs match file by file
(images equal, poses within rtol 1e-6, meshes within rtol 1e-6); the
reference test's own checks hold on the port's output.  Then the release
fixtures of ``test_torch_release_fixtures.py`` (a generated root as BOP
JSON, SIXD YAML and BOP with JPEG frames): the two packages' outputs match
again, and the converted root equals the generated one (poses within 1e-6
m, labels and PNG-sourced RGB equal, JPEG-sourced RGB equal to PIL's
decode, depth equal).
"""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from deepim_tpu.data import bop as bop_j
from deepim_tpu_torch.data import bop as bop_t
from deepim_tpu_torch.data.lm6d import LM6DDataset

sys.path.insert(0, os.path.dirname(__file__))
from test_bop_texture import _write_mini_bop, _write_mini_sixd  # noqa: E402
from test_torch_release_fixtures import (  # noqa: E402
    K_SMALL, _generated, assert_trees_match, compare_bop, write_bop_release)


def _both(src, tmp_path, obj_names, split="test"):
    out_j, out_t = str(tmp_path / "out_j"), str(tmp_path / "out_t")
    bop_j.convert_bop_split(src, split, out_j, obj_names)
    ds = bop_t.convert_bop_split(src, split, out_t, obj_names)
    assert assert_trees_match(out_j, out_t) > 0
    return ds


@pytest.mark.parametrize("form", ["json", "yaml"])
def test_convert_round_trip_matches_the_reference(tmp_path, form):
    src = str(tmp_path / form)
    (_write_mini_bop if form == "json" else _write_mini_sixd)(src)
    ds = _both(src, tmp_path, {5: "box"})
    mesh = ds.load_meshes()[0]
    assert 0.05 < mesh.diameter < 0.2  # ~0.13 m box diagonal
    recs = ds.gt_roidb("box", "test")
    assert len(recs) == 2
    np.testing.assert_allclose(recs[0].pose[:, 3], [0.01, -0.02, 0.7], atol=1e-6)
    frame = ds.load_frame(recs[0])
    assert frame["obs_rgb"].shape == (96, 128, 3)
    assert frame["obs_depth"].max() <= 0.11  # depth_scale 0.1: uint16 1000 -> 0.1 m
    if form == "json":
        assert frame["obs_mask"].sum() == 30 * 40  # the visible mask became the label
    scene = "000001" if form == "json" else "01"
    k = bop_t.bop_camera_k(src, "test", scene)
    assert k[0, 0] == 300.0 and k[1, 2] == 48.0
    np.testing.assert_array_equal(k, bop_j.bop_camera_k(src, "test", scene))


@pytest.mark.parametrize("form,rgb", [("json", "png"), ("yaml", "png"), ("json", "jpg")])
def test_release_fixture_converts_back_to_the_generated_root(tmp_path, form, rgb):
    objects = ["box", "icosphere"]
    gen = _generated(tmp_path, objects)
    src = str(tmp_path / "release")
    names = write_bop_release(gen, objects, src, K_SMALL, form=form, rgb=rgb)
    ds = _both(src, tmp_path, names)
    conv = ds.root
    rgb_ref = None
    if rgb == "jpg":
        def rgb_ref(scene, frame):
            ci = int(scene)
            path = os.path.join(src, "test", f"{ci + 1:06d}", "rgb", f"{int(frame):06d}.jpg")
            return np.asarray(Image.open(io.BytesIO(open(path, "rb").read())))
    d = compare_bop(gen, conv, objects, rgb_ref, form)
    assert d["frames"] == 6 and d["labels_equal"] and d["rgb_equal"], d
    assert d["pose_max_abs"] <= 1e-6 and d["depth_max_mm"] == 0, d
    assert [r.frame for r in LM6DDataset(conv, objects).gt_roidb("box", "test")] == [
        "000000", "000001", "000002"]
