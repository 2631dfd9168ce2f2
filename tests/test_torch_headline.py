"""deepim_tpu_torch.headline: the headline protocol chip_smoke.py drives.

Its assets must equal what the reference's bench.py builds for its
default protocol, and its two asset sets must take the two crop routes
(the cols kernel from 1,024 faces up, else the sorted kernel).
"""

import pytest
import torch

from deepim_tpu.geometry.symmetry import rot_z_syms
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.refine.refiner import build_assets as build_assets_j
from deepim_tpu_torch import headline as hl
from deepim_tpu_torch.raster import raster_cuda
from test_torch_assets import _assert_assets_equal


def test_headline_assets_equal_bench_defaults():
    # bench.py §main, default protocol: these meshes, symmetries and sizes.
    meshes = [mesh_j.box_mesh((0.08, 0.1, 0.06)), mesh_j.icosphere_mesh(0.05, subdivisions=3),
              mesh_j.cylinder_mesh(), mesh_j.torus_mesh()]
    aj = build_assets_j(meshes, sym_transforms=[rot_z_syms(2), None, None, rot_z_syms(8)],
                        num_points=3000, lod_faces=1024)
    _assert_assets_equal(hl.headline_assets("cpu"), aj)


def test_textured_headline_assets_equal_reference_atlas():
    # Mesh i of the bench's four gets the 64x64 procedural texture of seed i.
    meshes = [mesh_j.box_mesh((0.08, 0.1, 0.06)), mesh_j.icosphere_mesh(0.05, subdivisions=3),
              mesh_j.cylinder_mesh(), mesh_j.torus_mesh()]
    meshes = [mesh_j.texturize(m, seed=i, size=(64, 64)) for i, m in enumerate(meshes)]
    aj = build_assets_j(meshes, sym_transforms=[rot_z_syms(2), None, None, rot_z_syms(8)],
                        num_points=3000, lod_faces=1024)
    at = hl.headline_assets("cpu", textured=True)
    assert at.textured and at.textures.shape == (4, 64, 64, 3)
    _assert_assets_equal(at, aj)


@pytest.mark.parametrize("dense_sphere,route", [(True, "cols"), (False, "sort")])
def test_headline_asset_sets_take_both_crop_routes(dense_sphere, route):
    assets = hl.headline_assets("cpu", dense_sphere=dense_sphere)
    faces = assets.tri_pos.shape[2]
    assert (faces >= raster_cuda._COLS_MIN_FACES_CROP) == (route == "cols")
    assert assets.lod is None  # neither set reaches twice the LOD budget


def test_headline_inputs_seeded_and_shaped():
    a = hl.headline_inputs("cpu", num_classes=4, batch=5)
    b = hl.headline_inputs("cpu", num_classes=4, batch=5)
    obs, init, ks, cls = a
    assert obs.shape == (5, *hl.SIZE, 3) and init.shape == (5, 3, 4)
    assert ks.shape == (5, 3, 3) and cls.shape == (5,)
    assert int(cls.min()) >= 0 and int(cls.max()) < 4
    assert (init[:, 2, 3] > 0).all()  # in front of the camera
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_random_model_heads_move_poses():
    model = hl.random_model(num_classes=4, dtype=torch.float32)
    # The reference zero-initialises the pose heads; the noise makes them nonzero.
    assert model.fc_rot.weight.abs().max() > 0 and model.fc_trans.weight.abs().max() > 0
    again = hl.random_model(num_classes=4, dtype=torch.float32)
    for (n, p), (_, q) in zip(model.state_dict().items(), again.state_dict().items()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_serve_config_is_the_flagship_yaml():
    # chip_smoke.py serves this dict (the card's machine has no PyYAML): it
    # must be synthetic_all_c2f.yaml with the device batch raised to B.
    import dataclasses

    import yaml

    from deepim_tpu.config import update_config
    from deepim_tpu_torch.config import config_from_dict

    path = "experiments/cfgs/synthetic_all_c2f.yaml"
    with open(path) as f:
        expected = yaml.safe_load(f)
    expected["test"]["batch_size"] = hl.B
    assert hl.SERVE_CONFIG == expected
    cfg = config_from_dict(hl.SERVE_CONFIG)
    ref = update_config(path)
    assert cfg.test.batch_size == hl.B and ref.test.batch_size == 32
    for part in ("network", "dataset", "train"):
        assert dataclasses.asdict(getattr(cfg, part)) == dataclasses.asdict(getattr(ref, part))
    assert (cfg.network.input_height, cfg.network.input_width) == hl.SIZE
    assert (cfg.test.test_iter, cfg.test.coarse_iters) == (hl.K_ITERS, hl.COARSE_ITERS)


def test_train_config_is_the_flagship_training_yaml():
    # chip_smoke.py trains at this dict: synthetic_all.yaml, unchanged.
    import dataclasses

    import yaml

    from deepim_tpu.config import update_config
    from deepim_tpu_torch.config import config_from_dict

    path = "experiments/cfgs/synthetic_all.yaml"
    with open(path) as f:
        assert hl.TRAIN_CONFIG == yaml.safe_load(f)
    cfg, ref = config_from_dict(hl.TRAIN_CONFIG), update_config(path)
    for part in ("network", "dataset", "train", "test"):
        assert dataclasses.asdict(getattr(cfg, part)) == dataclasses.asdict(getattr(ref, part))
    n, t = cfg.network, cfg.train
    assert (n.input_height, n.input_width, n.dtype) == (*hl.SIZE, "bfloat16")
    assert n.with_flow and n.with_mask and t.optimizer == "adam"
    assert (t.batch_size, t.train_iter) == (32, 2)


@pytest.mark.parametrize("quant", ["none", "int8", "int8_static"])
def test_headline_runs_at_each_quant_mode(monkeypatch, quant):
    """The headline's quant modes (bench.py's BENCH_QUANT) on the CPU at a
    small size: int8_static calibrates on the headline batch with the
    estimator "max" (scalar scales), and the line names the mode."""
    monkeypatch.setattr(hl, "SIZE", (48, 64))
    monkeypatch.setattr(hl, "COARSE", (24, 32))
    assets = hl.headline_assets("cpu", dense_sphere=False)
    obs, init, ks, cls = hl.headline_inputs("cpu", assets.num_classes, batch=2)
    base = hl.random_model(assets.num_classes, dtype=torch.float32)
    model = hl.headline_model(base, quant, assets, obs, init, ks, cls)
    assert model.quant == ("none" if quant == "none" else "int8")
    assert bool(model.act_scales) == (quant == "int8_static")
    assert all(isinstance(s, float) for _, s in model.act_scales)
    out = hl.run_headline(model, assets, obs, init, ks, cls)
    assert out.shape == (2, 3, 4) and torch.isfinite(out).all()
    fields = hl.headline_fields(quant)
    assert fields["quant"] == quant
    assert fields["quant_calib"] == ("max" if quant == "int8_static" else None)


@pytest.mark.parametrize("quant,calib", [("int4", "max"), ("int8_static", "mx")])
def test_headline_rejects_unknown_quant(quant, calib):
    with pytest.raises(ValueError, match="is not one of"):
        hl.headline_fields(quant, calib)
    with pytest.raises(ValueError, match="is not one of"):
        hl.headline_model(None, quant, None, None, None, None, None, calib)
