"""deepim_tpu_torch.raster against deepim_tpu.raster on the CPU.

The JAX Pallas kernels run in interpret mode, as the repo's own raster
tests run them; the port's wrappers take their plain PyTorch versions on
CPU tensors.  Inputs are numpy, made from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.raster import raster_pallas as rp
from deepim_tpu.raster import raster_xla
from deepim_tpu.raster.mesh import box_mesh, cylinder_mesh, icosphere_mesh, torus_mesh
from deepim_tpu_torch.raster import raster_cuda as rc
from deepim_tpu_torch.raster import raster_ref
from deepim_tpu_torch.raster.mesh import cull_direction

H, W = 64, 128
K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
LIT = (0.3, 0.7, (0.3, -0.2, -1.0))


def _euler(ax, ay, az):
    cx, sx, cy, sy, cz, sz = (np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay),
                              np.cos(az), np.sin(az))
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _poses(n, seed, z=0.5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        r = _euler(*rng.uniform(-0.8, 0.8, 3))
        t = [rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
             rng.uniform(0.8 * z, 1.3 * z)]
        out.append(np.concatenate([r, np.asarray(t)[:, None]], 1))
    return np.asarray(out, np.float32)


def _tri(mesh, b):
    """Corner-major (B, 9, F) position / colour / normal stacks."""
    return [np.ascontiguousarray(np.broadcast_to(a[mesh.faces].reshape(-1, 9).T,
                                                 (b, 9, mesh.num_faces)))
            for a in (mesh.vertices, mesh.colors, mesh.normals)]


def _lighting(jax_side):
    amb, dif, d = LIT
    if jax_side:
        return raster_xla.Lighting(jnp.float32(amb), jnp.float32(dif),
                                   jnp.asarray(d, jnp.float32))
    return raster_ref.Lighting(amb, dif, d)


def _pack_both(mesh, poses, cull):
    b = poses.shape[0]
    tri = _tri(mesh, b)
    ks = np.broadcast_to(K, (b, 3, 3)).copy()
    cd = np.full((b,), cull_direction(mesh) if cull else 0.0, np.float32)
    pj = jax.vmap(lambda tp, tc, tn, p, kk, c: rp.pack_tri_params(
        tp, tc, tn, p, kk, _lighting(True), 0.01, c))(
            *map(jnp.asarray, (*tri, poses, ks, cd)))
    pt = rc.pack_tri_params(*map(torch.from_numpy, (*tri, poses, ks)),
                            _lighting(False), 0.01, torch.from_numpy(cd))
    return [np.array(a) for a in pj], [a.numpy() for a in pt]


def _compare(rgb_a, d_a, rgb_b, d_b, atol_frac=0.002):
    """The repo's raster tolerance (tests/test_raster_pallas.py §_compare)."""
    rgb_close = np.isclose(np.asarray(rgb_a), np.asarray(rgb_b), atol=2e-2)
    d_close = np.isclose(np.asarray(d_a), np.asarray(d_b), atol=1e-3)
    assert rgb_close.mean() > 1 - atol_frac, f"rgb mismatch {1 - rgb_close.mean():.4f}"
    assert d_close.mean() > 1 - atol_frac, f"depth mismatch {1 - d_close.mean():.4f}"
    assert (np.asarray(d_b) > 0).mean() > 0.02  # the object is on screen


CASES = [
    (icosphere_mesh(radius=0.08, subdivisions=2), 1, True),
    (torus_mesh(), 2, True),
    (box_mesh(size=(0.15, 0.12, 0.1)), 3, False),
]


@pytest.mark.parametrize("mesh,seed,cull", CASES)
def test_pack_matches(mesh, seed, cull):
    (pj, bj, okj), (pt, bt, okt) = _pack_both(mesh, _poses(2, seed, 0.45), cull)
    np.testing.assert_array_equal(okt, okj)
    # Relative to each parameter's scale: the C planes sum products of
    # pixel coordinates, so their absolute rounding grows with the image.
    scale = np.abs(pj).max(axis=(0, 1), keepdims=True) + 1e-6
    np.testing.assert_allclose(pt / scale, pj / scale, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt, bj, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("mesh,seed,cull", CASES)
def test_binning_equal_as_integers(mesh, seed, cull):
    (_, bbox, ok), _ = _pack_both(mesh, _poses(2, seed, 0.45), cull)
    bb_t, ok_t = torch.from_numpy(bbox), torch.from_numpy(ok)
    ref = jax.vmap(lambda bb, o: rp.bin_faces_packed(
        bb, o, (H, W), (8, 128), 6, 2, 120))(jnp.asarray(bbox), jnp.asarray(ok))
    got = rc.bin_faces_packed(bb_t, ok_t, (H, W))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for spans in ((4, 2), (8, 3), (2, 1)):
        ref = jax.vmap(lambda bb, o: rp.bin_faces_sorted(
            bb, o, (H, W), (32, 256), *spans))(jnp.asarray(bbox), jnp.asarray(ok))
        got = rc.bin_faces_sorted(bb_t, ok_t, (H, W), sy_span=spans[0],
                                  sx_span=spans[1])
        for g, r in zip(got, ref):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sorted_global_cap_drops_like_the_reference():
    # A tiny cap forces the lossy global list (ROADMAP C.2): both drop the
    # same faces and keep the capped count.
    (_, bbox, ok), _ = _pack_both(torus_mesh(), _poses(2, 2, 0.3), True)
    ref = jax.vmap(lambda bb, o: rp.bin_faces_sorted(
        bb, o, (H, W), (32, 256), 1, 1, 8))(jnp.asarray(bbox), jnp.asarray(ok))
    got = rc.bin_faces_sorted(torch.from_numpy(bbox), torch.from_numpy(ok), (H, W),
                              sy_span=1, sx_span=1, global_cap=8)
    assert int(got[2][:, 0].max()) == 8
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("binning", ["cols", "sort"])
@pytest.mark.parametrize("mesh,seed,cull", CASES[:2])
def test_plain_kernels_match_interpret(mesh, seed, cull, binning):
    poses = _poses(2, seed, 0.45)
    tri = _tri(mesh, 2)
    ks = np.broadcast_to(K, (2, 3, 3)).copy()
    cd = np.full((2,), cull_direction(mesh) if cull else 0.0, np.float32)
    rgb_j, d_j = rp.render_batch_tri(*map(jnp.asarray, (*tri, poses, ks)), (H, W),
                                     lighting=_lighting(True), interpret=True,
                                     binning=binning, cull_dir=jnp.asarray(cd))
    rc.reset_launches()
    rgb_t, d_t = rc.render_batch_tri(*map(torch.from_numpy, (*tri, poses, ks)),
                                     (H, W), lighting=_lighting(False),
                                     binning=binning, cull_dir=torch.from_numpy(cd))
    assert rgb_t.shape == (2, H, W, 3) and d_t.shape == (2, H, W)
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)
    assert rc.LAUNCHES["raster_cols"] == rc.LAUNCHES["raster_sorted"] == 0  # CPU


def test_plain_kernels_non_tile_aligned():
    # 50x70 leaves partial sub-tiles and tiles on both axes.
    mesh = icosphere_mesh(radius=0.08, subdivisions=1)
    poses = _poses(1, 6, 0.5)
    tri = _tri(mesh, 1)
    for binning in ("cols", "sort"):
        rgb_j, d_j = rp.render_batch_tri(*map(jnp.asarray, (*tri, poses, K[None])),
                                         (50, 70), interpret=True, binning=binning)
        rgb_t, d_t = rc.render_batch_tri(*map(torch.from_numpy, (*tri, poses, K[None])),
                                         (50, 70), binning=binning)
        assert d_t.shape == (1, 50, 70)
        _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)


def _overflow_case():
    """tests/test_raster_pallas.py §test_cols_global_overflow_falls_back_losslessly."""
    m = cylinder_mesh(radius=0.05, height=0.3, segments=512, rows=1)
    poses = np.stack([
        np.concatenate([_euler(np.pi / 2, 0.0, 0.0), [[0.0], [0.0], [0.4]]], 1),
        np.concatenate([_euler(np.pi / 2, 0.15, 0.1), [[0.01], [0.0], [0.45]]], 1),
    ]).astype(np.float32)
    k = np.array([[180.0, 0, W / 2], [0, 180.0, H / 2], [0, 0, 1]], np.float32)
    return m, poses, np.broadcast_to(k, (2, 3, 3)).copy()


def test_cols_overflow_falls_back_to_sorted():
    m, poses, ks = _overflow_case()
    tri = _tri(m, 2)
    params, bbox, ok = rc.pack_tri_params(*map(torch.from_numpy, (*tri, poses, ks)),
                                          rc.FLAT_LIGHTING, 0.01)
    glob = rc.bin_faces_packed(bbox, ok, (H, W))[2]
    assert int(glob[:, -1].max()) > 120  # more big faces than the cols cap
    rc.reset_launches()
    rgb_t, d_t = rc.render_batch_tri(*map(torch.from_numpy, (*tri, poses, ks)),
                                     (H, W), binning="cols")
    assert rc.LAUNCHES["cols_fallback"] == 1
    rgb_j, d_j = rp.render_batch_tri(*map(jnp.asarray, (*tri, poses, ks)), (H, W),
                                     interpret=True, binning="cols")
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)
    oracle = jax.vmap(lambda p, kk: raster_xla.render_mesh(
        jnp.asarray(m.vertices), jnp.asarray(m.faces), jnp.asarray(m.colors),
        jnp.asarray(m.normals), p, kk, (H, W)))
    _, d_o = oracle(jnp.asarray(poses), jnp.asarray(ks))
    sil = (d_t.numpy() > 0) == (np.asarray(d_o) > 0)
    assert sil.mean() > 0.999, f"silhouette mismatch {1 - sil.mean():.4f}"


def test_wrappers_dispatch_by_device():
    # CPU tensors take the plain versions (no launch counted); a device
    # with no kernel raises instead of falling back.
    params = torch.zeros((1, 8, 24))
    bbox = torch.zeros((1, 8, 4))
    ok = torch.ones((1, 8), dtype=torch.bool)
    rc.reset_launches()
    rgb, depth = rc.raster_cols(params, *rc.bin_faces_packed(bbox, ok, (16, 16)), 16, 16)
    assert rgb.shape == (1, 3, 16, 16) and not depth.any()
    rgb, depth = rc.raster_sorted(params, *rc.bin_faces_sorted(bbox, ok, (16, 16)), 16, 16)
    assert rgb.shape == (1, 3, 16, 16) and not depth.any()
    assert rc.LAUNCHES == {"raster_cols": 0, "raster_sorted": 0, "cols_fallback": 0}
    meta = [t.to("meta") for t in (params, *rc.bin_faces_packed(bbox, ok, (16, 16)))]
    with pytest.raises(ValueError):
        rc.raster_cols(*meta, 16, 16)


def test_dispatch_refuses_unported_routes():
    params = torch.zeros((1, 8, 24))
    bbox = torch.zeros((1, 8, 4))
    ok = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(NotImplementedError):
        rc._render_dispatch(params, bbox, ok, (16, 16), "topk")
    big = rc._FACE_CHUNK + 1
    with pytest.raises(NotImplementedError):
        rc._render_dispatch(torch.zeros((1, big, 24)), torch.zeros((1, big, 4)),
                            torch.ones((1, big), dtype=torch.bool), (16, 16), "auto")


@pytest.mark.parametrize("mesh,seed,cull", CASES)
def test_oracle_render_mesh_matches(mesh, seed, cull):
    pose = _poses(1, seed, 0.45)[0]
    cd = cull_direction(mesh) if cull else None
    args = (mesh.vertices, mesh.faces, mesh.colors, mesh.normals, pose, K)
    rgb_j, d_j = raster_xla.render_mesh(*map(jnp.asarray, args), (H, W),
                                        lighting=_lighting(True), cull_dir=cd)
    rgb_t, d_t = raster_ref.render_mesh(*map(torch.from_numpy, args), (H, W),
                                        lighting=_lighting(False), cull_dir=cd)
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j, atol_frac=1e-3)
