"""deepim_tpu_torch.native, the port's C++ host runtime, on the CPU.

Each of its seven entry points (PLY and OBJ parsing, vertex normals,
surface sampling, decimation, PNG decoding, the prefetch reader) is held
bit for bit against the reference's C++ (``deepim_tpu.native``, its own
build of the reference's source) and against its plain version: the
reference's numpy and Python paths (``plain=True`` in
``raster/mesh.py``), ``png.decode_png(data, plain=True)``,
``open().read()`` and ``native.sample_points_plain``.  The mesh helpers
are compared on icospheres of 20,480 and 81,920 faces (subdivisions 5
and 6), saved as ASCII and binary PLY and as OBJ; where the plain version
computes in another order its agreement is geometric: the decimation's
vertices come in another order (its triangles are the same corners), and
numpy's normals sum in another order (within 4 float32 ulps of a unit
vector).  PNGs cover every type the C++ takes, with all five row
filters; the types it refuses return None in both packages.  A root of
20,480-face OBJ and PLY models loads through ``load_assets_and_names``
into the reference's RenderAssets on both default routes.  A failed
build raises; no path goes on in Python without the library.
"""

import threading
from pathlib import Path

import numpy as np
import pytest

from deepim_tpu import native as native_j
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu_torch import native as native_t
from deepim_tpu_torch.data import lm6d as lm6d_t
from deepim_tpu_torch.data import png
from deepim_tpu_torch.raster import mesh as mesh_t
from test_torch_assets import _assert_assets_equal, _same_mesh
from test_torch_release_fixtures import encode_png_raw

ROOT = Path(__file__).resolve().parents[1]
SUBDIVS = (5, 6)  # 20,480 and 81,920 faces
NORMAL_ULPS = 4 * 2.0**-24  # numpy's summation order against the C++'s


def _write_obj(path: str, mesh) -> str:
    with open(path, "w") as f:
        f.write("# icosphere\n")
        for v, c in zip(mesh.vertices.tolist(), mesh.colors.tolist()):
            f.write("v {} {} {} {} {} {}\n".format(*v, *c))
        for a, b, c in (mesh.faces + 1).tolist():
            f.write(f"f {a} {b} {c}\n")
    return path


def _write_binary_ply(path: str, mesh) -> str:
    vert = np.zeros(mesh.num_vertices, [("xyz", "<f4", 3), ("rgb", "u1", 3)])
    vert["xyz"] = mesh.vertices
    vert["rgb"] = np.clip(mesh.colors * 255, 0, 255).astype(np.uint8)
    face = np.zeros(mesh.num_faces, [("n", "u1"), ("idx", "<i4", 3)])
    face["n"], face["idx"] = 3, mesh.faces
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {mesh.num_vertices}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {mesh.num_faces}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(vert.tobytes() + face.tobytes())
    return path


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """{subdivisions: (mesh, {"ascii": ply, "binary": ply, "obj": obj})}."""
    d = tmp_path_factory.mktemp("dense")
    out = {}
    for s in SUBDIVS:
        m = mesh_t.icosphere_mesh(0.05, subdivisions=s)
        paths = {"ascii": str(d / f"ico{s}.ply"), "binary": str(d / f"ico{s}_bin.ply"),
                 "obj": str(d / f"ico{s}.obj")}
        mesh_t.save_ply(paths["ascii"], m)
        _write_binary_ply(paths["binary"], m)
        _write_obj(paths["obj"], m)
        out[s] = (m, paths)
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert (x is None) == (y is None)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _around_the_unfilter(src: str) -> tuple[str, str]:
    """``src`` up to the PNG unfilter's output buffer, and from its 16-bit
    byte swap on."""
    cut = src.index("uint8_t* img = (uint8_t*)malloc(stride * h);\n")
    return src[:cut], src[src.index("  if (depth == 16) {\n", cut):]


def test_source_is_the_reference_source_below_its_header():
    """The port's copy carries the reference's code statement for statement
    but for its header comment and the PNG unfilter's loops (split by
    filter type; the bytes they give are held by the decode tests)."""
    ref = (ROOT / "native" / "src" / "deepim_native.cpp").read_text()
    own = native_t.SRC.read_text()
    ref_head, ref_tail = _around_the_unfilter(ref[ref.index("#include <cstdint>"):])
    own_head, own_tail = _around_the_unfilter(own)
    assert own_head.endswith(ref_head) and own_tail == ref_tail
    assert len(own_head) - len(ref_head) < 2000
    assert native_t.build().parent == png.BUILD_DIR
    assert native_t.build().name.startswith("libdeepim_host_")


@pytest.mark.parametrize("subdiv", SUBDIVS)
@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_load_ply_matches_reference_and_plain(dense, subdiv, fmt):
    m, paths = dense[subdiv]
    got = native_t.load_ply(paths[fmt])
    _equal(got, native_j.load_ply(paths[fmt]))
    v, c, f = got
    assert f.shape == (m.num_faces, 3)
    plain = mesh_t.load_ply(paths[fmt], plain=True)
    for x, y in ((v, plain.vertices), (c, plain.colors), (f, plain.faces)):
        np.testing.assert_array_equal(x, y)
    _same_mesh(mesh_t.load_ply(paths[fmt]), mesh_j.load_ply(paths[fmt]))


@pytest.mark.parametrize("subdiv", SUBDIVS)
def test_load_obj_matches_reference_and_plain(dense, subdiv):
    m, paths = dense[subdiv]
    got = native_t.load_obj(paths["obj"])
    _equal(got, native_j.load_obj(paths["obj"]))
    v, c, uv, f, mtllib, nmat = got
    assert uv is None and mtllib is None and nmat == 0 and f.shape == (m.num_faces, 3)
    plain = mesh_t.load_obj(paths["obj"], plain=True)
    for x, y in ((v, plain.vertices), (c, plain.colors), (f, plain.faces)):
        np.testing.assert_array_equal(x, y)
    _same_mesh(mesh_t.load_obj(paths["obj"]), mesh_j.load_obj(paths["obj"]))


@pytest.mark.parametrize("subdiv", SUBDIVS)
def test_vertex_normals_match_reference_and_plain(dense, subdiv):
    m, _ = dense[subdiv]
    got = native_t.vertex_normals(m.vertices, m.faces)
    np.testing.assert_array_equal(got, native_j.vertex_normals(m.vertices, m.faces))
    np.testing.assert_array_equal(got, mesh_t.compute_vertex_normals(m.vertices, m.faces))
    np.testing.assert_array_equal(got, m.normals)  # make_mesh took the C++ route
    plain = mesh_t.compute_vertex_normals(m.vertices, m.faces, plain=True)
    np.testing.assert_allclose(got, plain, rtol=0, atol=NORMAL_ULPS)
    # below the threshold the numpy path runs, as in the reference
    small = mesh_t.icosphere_mesh(0.05, subdivisions=3)
    np.testing.assert_array_equal(
        small.normals, mesh_t.compute_vertex_normals(small.vertices, small.faces, plain=True))


@pytest.mark.parametrize("subdiv", SUBDIVS)
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_points_match_reference_and_plain(dense, subdiv, seed):
    m, _ = dense[subdiv]
    got = native_t.sample_points(m.vertices, m.faces, 4096, seed)
    assert got.shape == (4096, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, native_j.sample_points(m.vertices, m.faces, 4096, seed))
    np.testing.assert_array_equal(got, native_t.sample_points_plain(m.vertices, m.faces, 4096,
                                                                    seed))
    none = np.zeros((0, 3), np.int32)
    assert native_t.sample_points(m.vertices, none, 8) is None
    assert native_t.sample_points_plain(m.vertices, none, 8) is None


def _corners(v, c, f):
    return v[f], c[f]  # (F, 3, 3) each: the triangles' corners, in face order


@pytest.mark.parametrize("subdiv", SUBDIVS)
@pytest.mark.parametrize("budget", [1024, 4096])
def test_decimate_matches_reference_and_plain(dense, subdiv, budget):
    m, _ = dense[subdiv]
    got = native_t.decimate(m.vertices, m.colors, m.faces, budget)
    _equal(got, native_j.decimate(m.vertices, m.colors, m.faces, budget))
    v, c, f = got
    assert 0 < len(f) <= budget and f.max() < len(v)
    plain = mesh_t.decimate_mesh(m, budget, plain=True)
    assert plain.num_faces == len(f) and plain.num_vertices == len(v)
    for x, y in zip(_corners(v, c, f), _corners(plain.vertices, plain.colors, plain.faces)):
        np.testing.assert_array_equal(x, y)
    assert native_t.decimate(m.vertices, m.colors, m.faces, m.num_faces) is None
    mj = mesh_j.Mesh(m.vertices, m.faces, m.colors, m.normals)
    _same_mesh(mesh_t.decimate_mesh(m, budget), mesh_j.decimate_mesh(mj, budget))


_TAKEN = [  # (colour type, bit depth, channels): what the C++ decodes
    (0, 8, 1), (4, 8, 2), (2, 8, 3), (6, 8, 4), (0, 16, 1)]


@pytest.mark.parametrize("colour,depth,channels", _TAKEN)
@pytest.mark.parametrize("size", [(37, 53), (120, 160)])
def test_decode_png_matches_reference_and_plain(colour, depth, channels, size):
    rng = np.random.RandomState(colour * 100 + depth + size[0])
    samples = rng.randint(0, 2**depth, (*size, channels))
    data = encode_png_raw(samples, colour, depth)
    got = native_t.decode_png(data)
    want = native_j.decode_png(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    plain = png.decode_png(data, plain=True)
    assert plain.dtype == got.dtype
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, samples.reshape(got.shape))
    np.testing.assert_array_equal(lm6d_t.decode_image(data), got)


@pytest.mark.parametrize("first", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("colour,depth,channels", [(2, 8, 3), (0, 16, 1)])
@pytest.mark.parametrize("size", [(9, 1), (7, 13)])
def test_decode_png_every_filter_on_the_first_row(first, colour, depth, channels, size):
    # the first row's filter reads a missing up row as zeros; one pixel wide,
    # every byte of a row has no left neighbour
    rng = np.random.RandomState(first * 10 + depth)
    samples = rng.randint(0, 2**depth, (*size, channels))
    kinds = (first,) + tuple(k for k in (4, 3, 2, 1, 0) if k != first)
    data = encode_png_raw(samples, colour, depth, kinds=kinds)
    got = native_t.decode_png(data)
    np.testing.assert_array_equal(got, native_j.decode_png(data))
    np.testing.assert_array_equal(got, png.decode_png(data, plain=True))
    np.testing.assert_array_equal(got, samples.reshape(got.shape))


def _refused():
    rng = np.random.RandomState(5)
    rgb = rng.randint(0, 256, (9, 11, 3))
    ok = encode_png_raw(rgb, 2, 8)
    bad_len = bytearray(ok)
    bad_len[8:12] = (2**30).to_bytes(4, "big")
    bad_zlib = bytearray(ok)
    bad_zlib[41:45] = b"\x00\x00\x00\x00"  # inside the IDAT stream
    return {
        "palette": encode_png_raw(rng.randint(0, 4, (9, 11)), 3, 8,
                                  palette=bytes(range(12))),
        "grey_4bit": encode_png_raw(rng.randint(0, 16, (9, 11)), 0, 4),
        "grey_1bit": encode_png_raw(rng.randint(0, 2, (9, 11)), 0, 1),
        "rgb_16bit": encode_png_raw(rng.randint(0, 2**16, (9, 11, 3)), 2, 16),
        "interlaced": encode_png_raw(rgb, 2, 8, interlace=True),
        "truncated": ok[:len(ok) // 2],
        "chunk_past_the_end": bytes(bad_len),
        "corrupt_stream": bytes(bad_zlib),
        "not_a_png": b"GIF89a" + bytes(64),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_decode_png_refuses_what_the_reference_refuses(case):
    data = _refused()[case]
    assert native_t.decode_png(data) is None
    assert native_j.decode_png(data) is None


def test_decode_image_takes_the_python_codec_where_the_cxx_refuses():
    data = _refused()["palette"]
    np.testing.assert_array_equal(lm6d_t.decode_image(data), png.decode_png(data))
    with pytest.raises(ValueError, match="not a PNG"):
        lm6d_t.decode_image(_refused()["not_a_png"])


def _files(tmp_path, n=24, missing=(3, 17)):
    paths = []
    for i in range(n):
        p = tmp_path / f"f{i:02d}.bin"
        if i not in missing:
            p.write_bytes(bytes([i]) * (1000 * i + 7))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("threads,capacity", [(1, 16), (4, 3), (4, 64)])
def test_prefetch_reader_order_and_missing_files(tmp_path, threads, capacity):
    paths = _files(tmp_path)
    want = [(i, open(p, "rb").read() if Path(p).exists() else None)
            for i, p in enumerate(paths)]
    reader = native_t.PrefetchReader(paths, num_threads=threads, capacity=capacity)
    got = list(reader)
    reader.close()
    reader.close()  # a second close is a no-op
    assert got == want
    ref = native_j.PrefetchReader(paths, num_threads=threads, capacity=capacity)
    assert list(ref) == got
    ref.close()
    with pytest.raises(ValueError, match="closed"):
        next(iter(reader))


def test_prefetch_reader_closed_midway_stops_its_threads(tmp_path):
    paths = _files(tmp_path, n=64, missing=())
    done = []

    def run():
        with native_t.PrefetchReader(paths, num_threads=4, capacity=2) as reader:
            it = iter(reader)
            done.append([next(it)[0] for _ in range(3)])
        done.append("closed")

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and done == [[0, 1, 2], "closed"]


def test_load_frames_prefetched_equals_load_frame(tmp_path):
    from deepim_tpu_torch.data import toolkit
    from deepim_tpu_torch.raster.camera import make_intrinsics

    k = make_intrinsics(60.0, 60.0, 32.0, 24.0, device="cpu").numpy()
    root = toolkit.gen_procedural_dataset(str(tmp_path / "root"), ["box", "icosphere"], k,
                                          (24, 32), frames_per_obj=3, device="cpu").root
    ds = lm6d_t.LM6DDataset(root, ["box", "icosphere"])
    recs = ds.gt_roidb("box", "test") + ds.gt_roidb("icosphere", "test")
    got = lm6d_t.load_frames_prefetched(ds, recs)
    assert len(got) == len(recs)
    for g, r in zip(got, recs):
        want = ds.load_frame(r)
        for key in ("obs_rgb", "obs_depth", "obs_mask"):
            assert g[key].dtype == want[key].dtype
            np.testing.assert_array_equal(g[key], want[key])


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """With no compiler the build raises naming it, and every route that
    needs the library raises too: none goes on in Python."""
    data = encode_png_raw(np.zeros((4, 4, 3), np.int64), 2, 8)
    big = mesh_t.icosphere_mesh(0.05, subdivisions=5)
    path = str(tmp_path / "box.ply")
    mesh_t.save_ply(path, mesh_t.box_mesh())
    monkeypatch.setattr(png, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_t, "_handle", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        native_t.build()
    with pytest.raises(RuntimeError, match="false failed"):
        native_t.decode_png(data)
    with pytest.raises(RuntimeError, match="false failed"):
        lm6d_t.decode_image(data)
    with pytest.raises(RuntimeError, match="false failed"):
        mesh_t.compute_vertex_normals(big.vertices, big.faces)
    with pytest.raises(RuntimeError, match="false failed"):
        mesh_t.decimate_mesh(big, 4096)
    with pytest.raises(RuntimeError, match="false failed"):
        mesh_t.load_ply(path)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_dense_root_assets_match_the_reference_default_route(dense, tmp_path):
    """A root of 20,480-face models (ASCII PLY and OBJ) through
    ``load_assets_and_names`` at max_faces 4096 and lod_faces 1024: both
    packages parse, compute normals and decimate in C++ and build equal
    RenderAssets, every field bit for bit."""
    from deepim_tpu.cli.train import load_assets_and_names as load_j
    from deepim_tpu.config import config_from_dict as config_j
    from deepim_tpu_torch.cli.train import load_assets_and_names as load_t
    from deepim_tpu_torch.config import config_from_dict

    m, paths = dense[5]
    root = tmp_path / "root"
    for obj, src, name in (("ape", "ascii", "textured.ply"), ("can", "obj", "textured.obj")):
        (root / "models" / obj).mkdir(parents=True)
        (root / "models" / obj / name).write_bytes(Path(paths[src]).read_bytes())
    spec = {"dataset": {"name": "lm6d", "objects": ["ape", "can"], "root": str(root),
                        "max_faces": 4096, "lod_faces": 1024, "num_points": 64},
            "test": {"coarse_iters": 1}}
    at, names_t, sym_t = load_t(config_from_dict(spec), device="cpu")
    aj, names_j, sym_j = load_j(config_j(spec))
    assert names_t == names_j == ["ape", "can"] and sym_t == sym_j
    assert at.lod is not None
    _assert_assets_equal(at, aj)
    assert at.tri_pos.shape[-1] == mesh_t.decimate_mesh(m, 4096).num_faces
