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
