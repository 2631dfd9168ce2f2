"""deepim_tpu_torch.data.lm_original against deepim_tpu.data.lm_original (CPU).

The six cases of ``tests/test_lm_original.py`` on the reference's own
fixtures (the release's formats: .dpt binary depth with either header
order, headed .rot/.tra text, an mm mesh, JPEG colour frames written by
PIL): the readers return the reference's arrays, both converters write the
same files (images equal, poses and meshes within rtol 1e-6: the port
decodes the JPEGs to PIL's pixels), and both validators give the same
findings on them.  Then the release fixture of a generated root
(``test_torch_release_fixtures.write_lm_original_release``): converted,
it equals the generated root (poses within 1e-6 m, depth within 1 mm, the
RGB PIL's decode of the JPEG, no label).
"""

import io
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from deepim_tpu.data import lm_original as lo_j
from deepim_tpu.data.validate import validate_lm6d as validate_j
from deepim_tpu_torch.data import lm_original as lo_t
from deepim_tpu_torch.data.lm6d import LM6DDataset
from deepim_tpu_torch.data.validate import validate_lm6d

sys.path.insert(0, os.path.dirname(__file__))
from test_lm_original import H, W, _write_dpt, _write_original_object  # noqa: E402
from test_torch_release_fixtures import (  # noqa: E402
    _generated, assert_trees_match, compare_lm_original, write_lm_original_release)


def _findings(fs):
    return [(f.level, f.code, f.path, f.message) for f in fs]


def test_read_dpt_header_and_swap(tmp_path):
    d = np.arange(H * W, dtype=np.float64).reshape(H, W)
    for swap in (False, True):
        p = str(tmp_path / f"{swap}.dpt")
        _write_dpt(p, d, swap_header=swap)
        got = lo_t.read_dpt(p)
        np.testing.assert_allclose(got, d / 1000.0, rtol=1e-6)
        np.testing.assert_array_equal(got, lo_j.read_dpt(p))


def test_read_dpt_rejects_truncated(tmp_path):
    p = str(tmp_path / "bad.dpt")
    with open(p, "wb") as f:
        f.write(struct.pack("<ii", H, W))
        np.zeros(10, np.uint16).tofile(f)
    with pytest.raises(ValueError, match="payload"):
        lo_t.read_dpt(p)


def test_read_rot_tra_units(tmp_path):
    rp, tp = str(tmp_path / "r.rot"), str(tmp_path / "t.tra")
    with open(rp, "w") as f:
        f.write("3 3\n1 0 0\n0 1 0\n0 0 1\n")
    np.testing.assert_array_equal(lo_t.read_rot(rp), np.eye(3))
    with open(tp, "w") as f:
        f.write("1 3\n2.0 -1.0 70.0\n")  # centimetres
    np.testing.assert_allclose(lo_t.read_tra(tp), [0.02, -0.01, 0.7])
    np.testing.assert_array_equal(lo_t.read_tra(tp), lo_j.read_tra(tp))
    with open(rp, "w") as f:  # headerless (some mirrors strip it)
        f.write("1 0 0 0 1 0 0 0 1\n")
    np.testing.assert_array_equal(lo_t.read_rot(rp), np.eye(3))
    with open(rp, "w") as f:
        f.write("2 2\n1 0 0 1\n")
    with pytest.raises(ValueError):
        lo_t.read_rot(rp)


def test_convert_and_preflight(tmp_path):
    src = str(tmp_path / "orig")
    poses = _write_original_object(src, "cat")
    _write_original_object(src, "duck")
    out_j, out_t = str(tmp_path / "lm6d_j"), str(tmp_path / "lm6d_t")
    lo_j.convert_lm_original(src, out_j)
    ds = lo_t.convert_lm_original(src, out_t)
    assert assert_trees_match(out_j, out_t) > 0
    assert ds.objects == ["cat", "duck"]
    recs = ds.gt_roidb("cat", "test")
    assert len(recs) == 2
    np.testing.assert_allclose(recs[0].pose, poses[0], atol=1e-6)
    fr = ds.load_frame(recs[0])
    assert fr["obs_rgb"].shape == (H, W, 3)
    assert abs(float(np.median(fr["obs_depth"][fr["obs_depth"] < 1.0])) - 0.7) < 2e-3
    assert float(np.abs(ds.load_meshes()[0].vertices).max()) < 0.2
    findings = validate_lm6d(out_t)
    assert not [f for f in findings if f.level == "ERROR"], [str(f) for f in findings]
    assert [f[:2] + f[3:] for f in _findings(findings)] == [
        f[:2] + f[3:] for f in _findings(validate_j(out_j))]


def test_convert_flags_wrong_tra_units(tmp_path):
    """A drop whose .tra is secretly mm converts to 10x-too-far poses; the
    preflight catches it, as the reference's does."""
    src = str(tmp_path / "orig")
    _write_original_object(src, "cat", tra_unit_cm=False)
    out = str(tmp_path / "lm6d")
    lo_t.convert_lm_original(src, out)
    found = _findings(validate_lm6d(out))
    assert {f[1] for f in found} & {"pose-translation-range", "depth-pose-mismatch",
                                    "pose-translation-units"}, found
    assert found == _findings(validate_j(out))


def test_no_label_written_uses_depth_fallback(tmp_path):
    src = str(tmp_path / "orig")
    _write_original_object(src, "cat")
    out = str(tmp_path / "lm6d")
    ds = lo_t.convert_lm_original(src, out)
    rec = ds.gt_roidb("cat", "test")[0]
    assert not os.path.exists(os.path.join(out, "data", "observed", "cat", "000000-label.png"))
    assert LM6DDataset(out, ["cat"]).load_frame(rec)["obs_mask"].any()


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_release_fixture_converts_back_to_the_generated_root(tmp_path, subsampling):
    objects = ["box", "icosphere"]
    gen = _generated(tmp_path, objects)
    src = str(tmp_path / "accv")
    write_lm_original_release(gen, objects, src, subsampling=subsampling)
    out_j, out_t = str(tmp_path / "out_j"), str(tmp_path / "out_t")
    lo_j.convert_lm_original(src, out_j)
    lo_t.convert_lm_original(src, out_t)
    assert_trees_match(out_j, out_t)

    def rgb_ref(scene, frame):
        path = os.path.join(src, objects[int(scene)], "data", f"color{int(frame)}.jpg")
        return np.asarray(Image.open(io.BytesIO(open(path, "rb").read())))

    d = compare_lm_original(gen, out_t, objects, rgb_ref)
    assert d["frames"] == 6 and d["labels_equal"] and d["rgb_equal"], d
    assert d["pose_max_abs"] <= 1e-6 and d["depth_max_mm"] <= 1, d
