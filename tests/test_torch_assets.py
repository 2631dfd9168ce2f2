"""The port's numpy mesh/symmetry copies and build_assets vs deepim_tpu.

The copies must stay bit-identical to the originals; every build_assets
field (the nested coarse lod included) must be equal.
"""

import inspect

import numpy as np
import pytest
import torch

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
    assert at._fields == aj._fields
    assert at.textured == aj.textured
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
    at = build_assets_t(meshes, sym_transforms=syms, num_points=300, lod_faces=1024, device="cpu")
    aj = build_assets_j(meshes, sym_transforms=syms, num_points=300, lod_faces=1024)
    assert at.lod is None  # 1,280 faces < 2 x 1,024: no coarse level
    assert at.tri_pos.shape == (4, 9, 1280)
    _assert_assets_equal(at, aj)


def test_build_assets_lod_equal():
    meshes, syms = _headline()
    at = build_assets_t(meshes, sym_transforms=syms, num_points=200, lod_faces=300, device="cpu")
    aj = build_assets_j(meshes, sym_transforms=syms, num_points=200, lod_faces=300)
    assert at.lod is not None and at.lod.tri_pos.shape[2] <= 300
    _assert_assets_equal(at, aj)


@pytest.mark.parametrize("textured", [[0], [0, 1]])
def test_build_assets_refuses_textured_meshes(textured):
    # Textured meshes build (their atlas is ported); what is refused is
    # use_textures=True on a set where no mesh has a texture.
    plain = [mesh_t.box_mesh(), mesh_t.icosphere_mesh()]
    with pytest.raises(ValueError, match="no mesh has a texture"):
        build_assets_t(plain, num_points=64, use_textures=True, device="cpu")
    meshes = list(plain)
    for i in textured:
        meshes[i] = mesh_j.texturize(meshes[i], seed=1)
    at = build_assets_t(meshes, num_points=64, device="cpu")
    assert at.textured and at.textures.shape == (2, 64, 64, 3)
    _assert_assets_equal(at, build_assets_j(meshes, num_points=64))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 11])
def test_texture_helper_copies_bit_identical(seed):
    np.testing.assert_array_equal(mesh_t.procedural_texture(seed),
                                  mesh_j.procedural_texture(seed))
    np.testing.assert_array_equal(mesh_t.procedural_texture(seed, (16, 40)),
                                  mesh_j.procedural_texture(seed, (16, 40)))
    m = mesh_t.torus_mesh()
    for axis in range(3):
        np.testing.assert_array_equal(mesh_t.planar_uv(m.vertices, axis),
                                      mesh_j.planar_uv(m.vertices, axis))
    _same_mesh(mesh_t.texturize(m, seed), mesh_j.texturize(m, seed))
    uv = np.random.RandomState(seed).uniform(-0.2, 1.2, (50, 2)).astype(np.float32)
    tex8 = (255 * mesh_t.procedural_texture(seed)).astype(np.uint8)  # 0-255 input
    for tex in (mesh_t.procedural_texture(seed), tex8):
        np.testing.assert_array_equal(mesh_t.bake_texture_to_vertices(uv, tex),
                                      mesh_j.bake_texture_to_vertices(uv, tex))


def _mixed_textured():
    """Textured meshes of two texture sizes, one texture without UVs, and an
    untextured mesh: every branch of ``_texture_fields``."""
    box = mesh_t.texturize(mesh_t.box_mesh((0.08, 0.1, 0.06)), 1, size=(32, 48))
    sphere = mesh_t.texturize(mesh_t.icosphere_mesh(0.05, subdivisions=3), 2)
    no_uv = mesh_t.Mesh(*(getattr(box, f) for f in ("vertices", "faces", "colors",
                                                    "normals")), texture=box.texture)
    return [box, sphere, no_uv, mesh_t.torus_mesh()]


@pytest.mark.parametrize("use_textures", [None, True, False])
def test_build_assets_textured_fields_equal(use_textures):
    meshes = _mixed_textured()
    at = build_assets_t(meshes, num_points=100, use_textures=use_textures, lod_faces=300,
                        device="cpu")
    aj = build_assets_j(meshes, num_points=100, use_textures=use_textures, lod_faces=300)
    assert at.textured == (use_textures is not False)
    _assert_assets_equal(at, aj)
    if at.textured:
        assert at.lod.textures is at.textures  # the coarse level shares the atlas


def test_entry_points_default_to_the_card():
    # build_assets and make_intrinsics put their tensors on the card unless
    # the caller asks for another device; random_quat follows its
    # generator and takes no device.  Read from the signatures: nothing is
    # made on a card.
    from deepim_tpu_torch.geometry.rotations import random_quat
    from deepim_tpu_torch.raster.camera import make_intrinsics

    for fn in (build_assets_t, make_intrinsics):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "device" not in inspect.signature(random_quat).parameters
    q = random_quat(torch.Generator().manual_seed(0), (3,))
    assert q.device.type == "cpu" and q.shape == (3, 4)


NEW_BUILDERS = [
    ("cone_mesh", {}),
    ("cone_mesh", {"radius": 0.03, "height": 0.07, "segments": 13}),
    ("capsule_mesh", {}),
    ("capsule_mesh", {"segments": 12, "rings": 3}),
    ("prism_mesh", {}),
    ("prism_mesh", {"n_sides": 3, "rx": 0.02, "ry": 0.05}),
    ("star_mesh", {}),
    ("star_mesh", {"points": 7, "r_inner": 0.03}),
    ("frustum_mesh", {}),
    ("tube_mesh", {}),
    ("lshape_mesh", {}),
    ("lshape_mesh", {"leg": 0.08, "width": 0.02}),
]


@pytest.mark.parametrize("name,kwargs", NEW_BUILDERS)
def test_zoo_builders_bit_identical(name, kwargs):
    mt, mj = getattr(mesh_t, name)(**kwargs), getattr(mesh_j, name)(**kwargs)
    _same_mesh(mt, mj)
    assert mt.diameter == mj.diameter


def test_polygon_helpers_bit_identical():
    star = np.stack([np.cos(np.pi * np.arange(10) / 5), np.sin(np.pi * np.arange(10) / 5)], -1)
    star *= np.where(np.arange(10) % 2 == 0, 0.05, 0.02)[:, None]
    assert mesh_t._triangulate_polygon(star) == mesh_j._triangulate_polygon(star)
    _same_mesh(mesh_t.extrude_polygon_mesh(star, 0.03), mesh_j.extrude_polygon_mesh(star, 0.03))
    parts = [mesh_t.box_mesh((0.1, 0.02, 0.02)), mesh_t.cone_mesh(), mesh_t.torus_mesh()]
    _same_mesh(mesh_t.merge_meshes(parts), mesh_j.merge_meshes(parts))


def test_procedural_meshes_bit_identical():
    # From 20,000 faces both packages compute vertex normals in C++ (each
    # its own build of the same source): those normals are bit-identical too.
    assert list(mesh_t.PROCEDURAL_MESHES) == list(mesh_j.PROCEDURAL_MESHES)
    assert mesh_t._NATIVE_MIN_FACES == mesh_j._NATIVE_MIN_FACES
    native = 0
    for name, make in mesh_t.PROCEDURAL_MESHES.items():
        mt, mj = make(), mesh_j.PROCEDURAL_MESHES[name]()
        native += mj.num_faces >= mesh_j._NATIVE_MIN_FACES
        _same_mesh(mt, mj)
    assert native == 2  # the two subdivision-5 icospheres


@pytest.mark.parametrize("seed,texture_prob", [(0, 0.5), (5, 1.0)])
def test_random_mesh_zoo_bit_identical(seed, texture_prob):
    assert mesh_t.ZOO_FAMILIES == mesh_j.ZOO_FAMILIES
    zt = mesh_t.random_mesh_zoo(14, seed, texture_prob=texture_prob)
    zj = mesh_j.random_mesh_zoo(14, seed, texture_prob=texture_prob)
    assert list(zt) == list(zj)
    assert any(m.texture is not None for m in zt.values())
    for name in zt:
        _same_mesh(zt[name], zj[name])


def test_symmetry_tables_equal():
    for table in ("LINEMOD_SYMMETRIC", "PROCEDURAL_SYMMETRIC", "YCB_SYMMETRIC",
                  "_YCB_SYMS", "_YCB_PREFIX"):
        t, j = getattr(sym_t, table), getattr(sym_j, table)
        assert list(t) == list(j), table
        for key in t:
            if isinstance(t[key], str) or isinstance(j[key], str):
                assert t[key] == j[key], (table, key)
            else:
                np.testing.assert_array_equal(t[key], j[key], err_msg=f"{table}[{key}]")


@pytest.mark.parametrize("yaml_name,eval_set", [
    ("synthetic_all_c2f.yaml", False),
    ("modelnet_small.yaml", False),
    ("modelnet_small.yaml", True),
    ("synthetic_textured.yaml", False),
])
def test_load_assets_and_names_match(yaml_name, eval_set):
    from deepim_tpu.cli.train import load_assets_and_names as load_j
    from deepim_tpu.config import update_config as update_j
    from deepim_tpu_torch.cli.train import load_assets_and_names as load_t
    from deepim_tpu_torch.config import update_config as update_t

    path = f"experiments/cfgs/{yaml_name}"
    at, names_t, sym_flags_t = load_t(update_t(path), eval_set=eval_set, device="cpu")
    aj, names_j, sym_flags_j = load_j(update_j(path), eval_set=eval_set)
    assert names_t == names_j and sym_flags_t == sym_flags_j
    assert any(sym_flags_t)
    _assert_assets_equal(at, aj)


@pytest.mark.parametrize("overrides", [
    {"dataset": {"name": "lm6d", "objects": ["ape"]}},
    {"dataset": {"name": "ycb", "objects": ["bowl"]}},
    {"dataset": {"name": "modelnet", "cad_dir": "meshes", "eval_objects": ["torus"]}},
])
def test_load_assets_from_disk_is_not_ported(overrides, tmp_path):
    """Meshes read from disk (once not ported, now the loaders' path):
    ``models/ape/textured.ply``, ``models/bowl/textured.obj`` with an MTL
    colour, a ModelNet ``cad_dir`` of an .off and an .obj file (normalised,
    decimated), each loaded by both packages into equal assets, each on its
    default route (PLY and OBJ parsed in C++)."""
    from deepim_tpu.cli.train import load_assets_and_names as load_j
    from deepim_tpu.config import config_from_dict as config_j
    from deepim_tpu_torch.cli.train import load_assets_and_names as load_t
    from deepim_tpu_torch.config import config_from_dict

    root = tmp_path / "root"
    (root / "models" / "ape").mkdir(parents=True)
    mesh_t.save_ply(str(root / "models" / "ape" / "textured.ply"),
                    mesh_t.icosphere_mesh(0.04, subdivisions=2))
    (root / "models" / "bowl").mkdir(parents=True)
    (root / "models" / "bowl" / "textured.mtl").write_text("newmtl m\nKd 0.2 0.5 0.9\n")
    box = mesh_t.box_mesh((0.1, 0.08, 0.06))
    obj = "mtllib textured.mtl\nusemtl m\n" + "".join(
        f"v {x} {y} {z}\n" for x, y, z in box.vertices) + "".join(
        f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in box.faces)
    (root / "models" / "bowl" / "textured.obj").write_text(obj)
    (root / "meshes").mkdir()
    (root / "meshes" / "b.obj").write_text(obj.replace("mtllib textured.mtl\n", ""))
    cyl = mesh_t.cylinder_mesh(segments=12)
    (root / "meshes" / "a.off").write_text(
        f"OFF{cyl.num_vertices} {cyl.num_faces} 0\n"
        + "".join(f"{x * 40} {y * 40} {z * 40 + 3}\n" for x, y, z in cyl.vertices)
        + "".join(f"3 {a} {b} {c}\n" for a, b, c in cyl.faces))
    spec = {**overrides, "dataset": {**overrides["dataset"], "root": str(root),
                                     "max_faces": 64, "num_points": 32}}
    if "cad_dir" in spec["dataset"]:
        spec["dataset"]["cad_dir"] = str(root / "meshes")
    for eval_set in (True, False):
        at, names_t, sym_t_ = load_t(config_from_dict(spec), eval_set=eval_set, device="cpu")
        aj, names_j, sym_j_ = load_j(config_j(spec), eval_set=eval_set)
        assert names_t == names_j and sym_t_ == sym_j_
        _assert_assets_equal(at, aj)
        if eval_set:
            assert names_t == {"lm6d": ["ape"], "ycb": ["bowl"], "modelnet": ["a", "b"]}[
                spec["dataset"]["name"]]
