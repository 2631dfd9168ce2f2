"""The port's numpy mesh/symmetry copies and build_assets vs deepim_tpu.

The copies must stay bit-identical to the originals; every build_assets
field (the nested coarse lod included) must be equal.
"""

import numpy as np
import pytest

from deepim_tpu.geometry import symmetry as sym_j
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.refine.refiner import build_assets as build_assets_j
from deepim_tpu_torch.geometry import symmetry as sym_t
from deepim_tpu_torch.raster import mesh as mesh_t
from deepim_tpu_torch.refine.refiner import build_assets as build_assets_t

BUILDERS = [
    ("box_mesh", {"size": (0.08, 0.1, 0.06)}),
    ("box_mesh", {"face_colors": np.eye(3)[[0, 1, 2, 0, 1, 2]]}),
    ("icosphere_mesh", {"radius": 0.05, "subdivisions": 3}),
    ("cylinder_mesh", {}),
    ("cylinder_mesh", {"segments": 40, "rows": 3}),
    ("torus_mesh", {}),
]
FIELDS = ("vertices", "faces", "colors", "normals", "uv", "texture")


def _same_mesh(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name,kwargs", BUILDERS)
def test_mesh_copies_bit_identical(name, kwargs):
    mt, mj = getattr(mesh_t, name)(**kwargs), getattr(mesh_j, name)(**kwargs)
    _same_mesh(mt, mj)
    assert mt.diameter == mj.diameter
    _same_mesh(mesh_t.pad_mesh(mt, mt.num_vertices + 5, mt.num_faces + 7),
               mesh_j.pad_mesh(mj, mj.num_vertices + 5, mj.num_faces + 7))
    _same_mesh(mesh_t.decimate_mesh(mt, mt.num_faces // 3),
               mesh_j.decimate_mesh(mj, mj.num_faces // 3))
    np.testing.assert_array_equal(mesh_t.sample_points(mt, 500, seed=3),
                                  mesh_j.sample_points(mj, 500, seed=3))
    assert mesh_t.cull_direction(mt) == mesh_j.cull_direction(mj)
    v, f = mt.vertices, mt.faces
    np.testing.assert_array_equal(mesh_t.compute_vertex_normals(v, f),
                                  mesh_j.compute_vertex_normals(v, f))


def test_symmetry_copies_bit_identical():
    assert sym_t.CONTINUOUS_Z == sym_j.CONTINUOUS_Z
    assert sym_t.CONTINUOUS_Z_DISCRETE == sym_j.CONTINUOUS_Z_DISCRETE
    np.testing.assert_array_equal(sym_t.identity_pose(), sym_j.identity_pose())
    for n in (1, 2, 8):
        np.testing.assert_array_equal(sym_t.rot_z_syms(n), sym_j.rot_z_syms(n))
    for s in (None, sym_j.rot_z_syms(2), sym_j.CONTINUOUS_Z):
        np.testing.assert_array_equal(sym_t.sym_set(s, 16), sym_j.sym_set(s, 16))
    with pytest.raises(ValueError):
        sym_t.sym_set(sym_j.rot_z_syms(8), 4)


def _assert_assets_equal(at, aj):
    # The reference's extra fields are its texture atlas, unset when no
    # mesh is textured (the port refuses textured meshes).
    extra = set(aj._fields) - set(at._fields)
    assert extra == {"tri_uv", "textures", "tex_idx"}
    assert all(getattr(aj, f) is None for f in extra)
    for f in at._fields:
        x, y = getattr(at, f), getattr(aj, f)
        if f == "lod":
            assert (x is None) == (y is None)
            if x is not None:
                _assert_assets_equal(x, y)
            continue
        assert (x is None) == (y is None), f
        if x is not None:
            y = np.asarray(y)
            assert x.numpy().dtype == y.dtype, f
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f)


def _headline(icosphere_subdiv=3):
    return (
        [mesh_t.box_mesh((0.08, 0.1, 0.06)),
         mesh_t.icosphere_mesh(0.05, subdivisions=icosphere_subdiv),
         mesh_t.cylinder_mesh(), mesh_t.torus_mesh()],
        [sym_t.rot_z_syms(2), None, sym_t.CONTINUOUS_Z, sym_t.rot_z_syms(8)],
    )


def test_build_assets_fields_equal():
    meshes, syms = _headline()
    at = build_assets_t(meshes, sym_transforms=syms, num_points=300, lod_faces=1024)
    aj = build_assets_j(meshes, sym_transforms=syms, num_points=300, lod_faces=1024)
    assert at.lod is None  # 1,280 faces < 2 x 1,024: no coarse level
    assert at.tri_pos.shape == (4, 9, 1280)
    _assert_assets_equal(at, aj)


def test_build_assets_lod_equal():
    meshes, syms = _headline()
    at = build_assets_t(meshes, sym_transforms=syms, num_points=200, lod_faces=300)
    aj = build_assets_j(meshes, sym_transforms=syms, num_points=200, lod_faces=300)
    assert at.lod is not None and at.lod.tri_pos.shape[2] <= 300
    _assert_assets_equal(at, aj)


@pytest.mark.parametrize("textured", [[0], [0, 1]])
def test_build_assets_refuses_textured_meshes(textured):
    meshes = [mesh_t.box_mesh(), mesh_t.icosphere_mesh()]
    for i in textured:
        meshes[i] = mesh_j.texturize(meshes[i], seed=1)
    with pytest.raises(NotImplementedError, match="textured"):
        build_assets_t(meshes, num_points=64)
