"""deepim_tpu_torch.raster.mesh's OBJ/OFF loaders against deepim_tpu's (CPU).

Every case of tests/test_mesh_formats.py, each file read by both packages:
geometry, colours, UVs and baked textures must be bit-identical.  Both
packages parse untextured PLY and single-material OBJ files in C++ (each
its own build of one source), so each case compares the two default routes,
and then the two Python paths: the reference's helper switched off
(``native.available`` patched to False) against the port's loader with
``plain=True``, the route a file takes that the C++ does not parse.
"""

import os

import numpy as np
import pytest

from deepim_tpu import native
from deepim_tpu.data import lm6d as lm6d_j
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu_torch.data import lm6d as lm6d_t
from deepim_tpu_torch.data.png import write_png
from deepim_tpu_torch.raster import mesh as mesh_t
from test_mesh_formats import _obj_text, _off_text, _write

FIELDS = ("vertices", "faces", "colors", "normals", "uv", "texture")


def _same(a, b, fields=FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _both(path, loader="load_mesh", monkeypatch=None):
    """The port's mesh of ``path`` against the reference's on their default
    routes, then on their Python paths -> the port's default mesh."""
    got = getattr(mesh_t, loader)(path)
    _same(got, getattr(mesh_j, loader)(path))
    monkeypatch.setattr(native, "available", lambda: False)
    _same(getattr(mesh_t, loader)(path, plain=True), getattr(mesh_j, loader)(path))
    monkeypatch.undo()
    return got


def _textured_obj(tmp_path):
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, 4:] = 255
    write_png(str(tmp_path / "tex.png"), tex)
    _write(tmp_path / "m.mtl", "newmtl mat0\nKd 0.2 0.4 0.6\nmap_Kd tex.png\n")
    return _write(tmp_path / "q.obj", (
        "mtllib m.mtl\n"
        "v 0 0 0\nv 0.1 0 0\nv 0.1 0.1 0\nv 0 0.1 0\n"
        "vt 0.05 0.5\nvt 0.95 0.5\nvt 0.95 0.5\nvt 0.05 0.5\n"
        "usemtl mat0\n"
        "f 1/1 2/2 3/3 4/4\n"))


@pytest.mark.parametrize("case", ["basic", "vertex_colors", "negative_indices"])
def test_obj_geometry_and_colours(tmp_path, monkeypatch, case):
    text = {"basic": _obj_text(), "vertex_colors": _obj_text(with_colors=True),
            "negative_indices": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"}[case]
    m = _both(_write(tmp_path / "a.obj", text), "load_obj", monkeypatch)
    assert m.num_faces == {"negative_indices": 1}.get(case, 12)
    if case == "vertex_colors":
        assert m.colors[m.vertices[:, 0] > 0, 0].mean() > m.colors[m.vertices[:, 0] < 0, 0].mean()


def test_obj_mtl_and_texture_bake(tmp_path, monkeypatch):
    m = _both(_textured_obj(tmp_path), "load_obj", monkeypatch)
    assert m.uv is not None and m.texture is not None and m.texture.shape == (8, 8, 3)
    left, right = m.colors[np.isclose(m.uv[:, 0], 0.05)], m.colors[np.isclose(m.uv[:, 0], 0.95)]
    assert left.max() < 0.2 and right.min() > 0.8
    # A Kd-only material: a flat diffuse colour.
    _write(tmp_path / "kd.mtl", "newmtl flat\nKd 0.9 0.1 0.3\n")
    m2 = _both(_write(tmp_path / "kd.obj", "mtllib kd.mtl\nv 0 0 0\nv 0.1 0 0\nv 0 0.1 0\n"
                      "usemtl flat\nf 1 2 3\n"), "load_obj", monkeypatch)
    np.testing.assert_allclose(m2.colors[0], [0.9, 0.1, 0.3], atol=1e-6)


def test_obj_two_materials_and_grey_map(tmp_path, monkeypatch):
    """Two materials (the reference's Python-only path): one textured by a
    grey map (read as RGB), one flat Kd; the texture stays off the mesh
    only when more than one map is used."""
    write_png(str(tmp_path / "g.png"), (np.arange(64).reshape(8, 8) * 4).astype(np.uint8))
    _write(tmp_path / "two.mtl", "newmtl a\nmap_Kd g.png\nnewmtl b\nKd 0.1 0.8 0.2\n")
    obj = ("mtllib two.mtl\nv 0 0 0\nv 0.1 0 0\nv 0.1 0.1 0\nv 0 0.1 0\nv 0.2 0 0\n"
           "vt 0.1 0.1\nvt 0.9 0.2\nvt 0.5 0.9\n"
           "usemtl a\nf 1/1 2/2 3/3\nusemtl b\nf 3/3 4/1 5/2\n")
    m = _both(_write(tmp_path / "two.obj", obj), "load_obj", monkeypatch)
    assert m.texture is not None and m.texture.shape == (8, 8, 3)


def test_obj_uv_corner_dedup(tmp_path, monkeypatch):
    obj = ("v 0 0 0\nv 0.1 0 0\nv 0 0.1 0\nvt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\n"
           "f 1/1 2/2 3/3\nf 1/4 2/2 3/3\n")
    m = _both(_write(tmp_path / "seam.obj", obj), "load_obj", monkeypatch)
    assert (m.num_vertices, m.num_faces) == (4, 2)


@pytest.mark.parametrize("kind", ["plain", "glued", "face_colors"])
def test_off_geometry_and_quirks(tmp_path, monkeypatch, kind):
    text = _off_text(glued_header=kind == "glued", face_colors=kind == "face_colors")
    m = _both(_write(tmp_path / "box.off", text), "load_off", monkeypatch)
    assert (m.num_vertices, m.num_faces) == (8, 12)
    if kind == "face_colors":
        np.testing.assert_allclose(m.colors[:, :2], [[1.0, 0.0]] * 8)


def test_coff_vertex_colors(tmp_path, monkeypatch):
    lines = ["COFF", "3 1 0"]
    for i, v in enumerate([(0, 0, 0), (0.1, 0, 0), (0, 0.1, 0)]):
        lines.append(f"{v[0]} {v[1]} {v[2]} {85 * (i + 1)} 0 0 255")
    lines.append("3 0 1 2")
    m = _both(_write(tmp_path / "c.off", "\n".join(lines) + "\n"), "load_off", monkeypatch)
    np.testing.assert_allclose(m.colors[:, 0], [1 / 3, 2 / 3, 1.0], atol=0.01)


@pytest.mark.parametrize("text", ["PLY\n", "OFF\n8 12 0\n0 0 0\n"])
def test_off_refuses_what_the_reference_refuses(tmp_path, text):
    path = _write(tmp_path / "bad.off", text)
    with pytest.raises(ValueError) as got:
        mesh_t.load_off(path)
    with pytest.raises(ValueError) as want:
        mesh_j.load_off(path)
    assert str(got.value) == str(want.value)


def test_obj_off_ply_roundtrip(tmp_path, monkeypatch):
    """The same box as OBJ, OFF and PLY loads to the same geometry in both
    packages (the reference test renders them too; the port's renders are
    tests/test_torch_raster.py's)."""
    obj = _both(_write(tmp_path / "box.obj", _obj_text()), monkeypatch=monkeypatch)
    off = _both(_write(tmp_path / "box.off", _off_text()), monkeypatch=monkeypatch)
    mesh_t.save_ply(str(tmp_path / "box.ply"), obj)
    ply = _both(str(tmp_path / "box.ply"), monkeypatch=monkeypatch)
    for other in (off, ply):
        np.testing.assert_allclose(obj.vertices, other.vertices, atol=1e-6)
        np.testing.assert_array_equal(obj.faces, other.faces)


@pytest.mark.parametrize("diameter", [0.15, 0.4])
def test_normalize_mesh(diameter):
    for m in (mesh_t.box_mesh((0.3, 0.2, 0.1)), mesh_t.texturize(mesh_t.torus_mesh(), 3)):
        got = mesh_t.normalize_mesh(m, diameter=diameter)
        _same(got, mesh_j.normalize_mesh(m, diameter=diameter))
        assert abs(got.diameter - diameter) < 1e-5


def test_load_mesh_dispatch_unknown(tmp_path):
    with pytest.raises(ValueError, match="unsupported mesh format"):
        mesh_t.load_mesh(str(tmp_path / "x.stl"))


def test_lm6d_model_path_probes_obj(tmp_path):
    """LM6DDataset finds textured.obj where no .ply exists (the YCB layout)
    and loads the same mesh as the reference."""
    os.makedirs(tmp_path / "models" / "thing")
    _write(tmp_path / "models" / "thing" / "textured.obj", _obj_text())
    ds = lm6d_t.LM6DDataset(str(tmp_path), ["thing"])
    assert ds.model_path("thing").endswith("textured.obj")
    assert ds.model_path("thing") == lm6d_j.LM6DDataset(str(tmp_path), ["thing"]).model_path(
        "thing")
    (got,) = ds.load_meshes()
    (want,) = lm6d_j.LM6DDataset(str(tmp_path), ["thing"]).load_meshes()
    _same(got, want)
    assert got.num_faces == 12
    assert lm6d_t.LM6DDataset.discover_objects(str(tmp_path)) == ["thing"]
