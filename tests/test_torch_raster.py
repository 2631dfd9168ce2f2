"""deepim_tpu_torch.raster against deepim_tpu.raster on the CPU.

The JAX Pallas kernels run in interpret mode, as the repo's own raster
tests run them; the port's wrappers take their plain PyTorch versions on
CPU tensors.  Inputs are numpy, made from fixed seeds.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.raster import raster_pallas as rp
from deepim_tpu.raster import raster_xla
from deepim_tpu.raster.mesh import box_mesh, cylinder_mesh, icosphere_mesh, torus_mesh
from deepim_tpu_torch.raster import mesh as mesh_t
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


# The per-warp cull of the three kernels' shared walk
# (csrc/raster_common.cuh): a warp owns a rectangle of 32x8 pixels and
# skips a face when one of its planes, evaluated at the corner of the
# rectangle where it is largest, says no pixel there is covered or won.
# The kernels can only be run on the card; these tests hold the cull's
# arithmetic, in the plain versions' rounded order, to what it must keep,
# and each kernel's lists and order.


CULL_FRAMES = ((64, 96), (64, 80))  # the second clips the last warp column


def _plane(q, i, x, y):
    """The rounded plane a*x + b*y + c, in the order _resolve_ref uses."""
    return q[..., i] * x + q[..., i + 1] * y + q[..., i + 2]


def _cull_keeps(q, xl, xh, yl, yh):
    """The kernel's test of faces ``q`` (..., 24) on the rectangle of pixel
    centres [xl, xh] x [yl, yh]: each plane at its largest corner."""
    def top(i):
        x = torch.where(q[..., i] >= 0, xh, xl)
        return _plane(q, i, x, torch.where(q[..., i + 1] >= 0, yh, yl))

    return (top(0) >= 0) & (top(3) >= 0) & (top(6) >= 0) & (top(9) > 0)


def _warp_rects(h, w):
    """(xl, xh, yl, yh) pixel-centre bounds of every warp rectangle of an
    h x w frame, clipped to it, as float32 scalars."""
    f32 = lambda v: torch.tensor(v + 0.5, dtype=torch.float32)  # noqa: E731
    return [(f32(x), f32(min(x + 31, w - 1)), f32(y), f32(min(y + 7, h - 1)))
            for y in range(0, h, 8) for x in range(0, w, 32)]


def _cull_faces(seed, n=100):
    """Faces packed by _plane_pack, (params (1, N, 24), bbox (1, N, 4)):
    random ones crossing the frame's edges, slivers (the third corner a
    hair off the line of the other two, some of those lines through pixel
    centres), micro-faces with |d| around the 1e-12 cut, faces far larger
    than the frame, and culled ones (corner behind the camera or back
    facing)."""
    rng = np.random.RandomState(seed)
    a, b = rng.uniform([-20, -20], [116, 84], (2, n, 2))
    rand = np.stack([a, b, rng.uniform([-20, -20], [116, 84], (n, 2))], 1)
    # slivers: a hair (log-uniform 1e-7..1e-2 px) off the line a-b
    u = rng.uniform(0.1, 0.9, (n, 1))
    nrm = (b - a)[:, ::-1] * [1, -1]
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    off = 10.0 ** rng.uniform(-7, -2, (n, 1))
    sliver = np.stack([a, b, a + u * (b - a) + off * nrm], 1)
    # horizontal slivers on rows of pixel centres, as in the bbox test below
    y = rng.randint(0, 64, (n // 2, 1)) + 0.5
    xa, xb = rng.uniform(-10, 100, (2, n // 2, 1))
    row = np.stack([np.c_[xa, y], np.c_[xb, y],
                    np.c_[(xa + xb) / 2, y + 10.0 ** rng.uniform(-7, -5, (n // 2, 1))]], 1)
    # micro-faces: edges of ~1e-6 px near (1, 1), |d| spread about 1e-12
    c = rng.uniform(0.5, 3.0, (n // 2, 1, 2))
    micro = c + rng.uniform(-1, 1, (n // 2, 3, 2)) * 10.0 ** rng.uniform(-7, -5, (n // 2, 1, 1))
    huge = rng.uniform(-3000, 3000, (n // 2, 3, 2))
    xy = torch.from_numpy(np.concatenate([rand, sliver, row, micro, huge]).astype(np.float32))
    m = xy.shape[0]
    z = torch.from_numpy(rng.uniform(0.3, 2.0, (3, 1, m)).astype(np.float32))
    ok = torch.from_numpy(rng.uniform(size=(1, m)) > 0.1)  # some behind the camera
    col = tuple(tuple(torch.from_numpy(rng.uniform(size=(1, m)).astype(np.float32))
                      for _ in range(3)) for _ in range(3))
    corners = tuple((xy[None, :, i, 0], xy[None, :, i, 1]) for i in range(3))
    cull = torch.tensor([[1.0 if seed % 2 else 0.0]])  # back faces culled on odd seeds
    params, bbox, _ = rc._plane_pack(corners, tuple(z), col, ok, cull)
    return params, bbox


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_cull_keeps_every_covering_face(seed):
    # For every face and warp rectangle: each plane's largest rounded value
    # over the rectangle's pixels is the kernel's corner value (rounding is
    # monotone), so a face that covers a pixel there with positive inverse
    # depth always passes the cull.
    params, _ = _cull_faces(seed)
    q = params[0][:, None, :]  # (N, 1, 24)
    kept = covered = 0
    for h, w in CULL_FRAMES:
        for xl, xh, yl, yh in _warp_rects(h, w):
            xs = torch.arange(int(xl), int(xh) + 1, dtype=torch.float32) + 0.5
            ys = torch.arange(int(yl), int(yh) + 1, dtype=torch.float32) + 0.5
            px, py = (t.reshape(1, -1) for t in torch.meshgrid(xs, ys, indexing="xy"))
            planes = [_plane(q, i, px, py) for i in (0, 3, 6, 9)]  # each (N, P)
            for i, pl in zip((0, 3, 6, 9), planes):
                a, b = q[:, 0, i], q[:, 0, i + 1]
                top = _plane(q[:, 0], i, torch.where(a >= 0, xh, xl),
                             torch.where(b >= 0, yh, yl))
                assert torch.equal(pl.max(1).values, top)
            cov = ((planes[0] >= 0) & (planes[1] >= 0) & (planes[2] >= 0)
                   & (planes[3] > 0)).any(1)
            keep = _cull_keeps(q[:, 0], xl, xh, yl, yh)
            assert not (cov & ~keep).any()
            kept += int(keep.sum())
            covered += int(cov.sum())
    n_tests = params.shape[1] * sum(len(_warp_rects(*f)) for f in CULL_FRAMES)
    assert 0 < covered <= kept < 0.5 * n_tests  # it culls, and not everything


def test_sorted_cull_bbox_is_not_a_bound():
    # Why the cull evaluates planes instead of testing the face's bbox: a
    # sliver 1e-6 px thick on the row of centres y = 10.5 covers, under the
    # rounded plane arithmetic, pixels up to 9.5 px left of its bbox.
    xy = torch.tensor([[10.0, 10.5], [50.0, 10.5], [30.0, 10.5 + 1e-6]])
    corners = tuple((xy[None, None, i, 0], xy[None, None, i, 1]) for i in range(3))
    one = torch.ones((1, 1))
    params, bbox, ok = rc._plane_pack(corners, (one, one, one), ((one,) * 3,) * 3,
                                      torch.ones((1, 1), dtype=torch.bool))
    assert bool(ok)
    q = params[0, 0]
    xs = torch.arange(64, dtype=torch.float32) + 0.5
    y = torch.tensor(10.5)
    cov = (_plane(q, 0, xs, y) >= 0) & (_plane(q, 3, xs, y) >= 0) & (_plane(q, 6, xs, y) >= 0)
    outside = cov & ((xs < bbox[0, 0, 0] - 1) | (xs > bbox[0, 0, 1] + 1))
    assert outside.any() and float(xs[outside].min()) < 5.0
    # the warp rectangle x 0..31, y 8..15 holds those pixels: the cull keeps it
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    assert bool(_cull_keeps(q, f32(0.5), f32(31.5), f32(8.5), f32(15.5)))


def _tile_rects(t, h, w):
    """Origins of the live 32x8 warp rectangles of row-major 32x256 tile t."""
    th, tw = rc.SORT_TILE
    tx = -(-w // tw)
    oy, ox = (t // tx) * th, (t % tx) * tw
    return [(x0, y0) for y0 in range(oy, min(oy + th, h), 8)
            for x0 in range(ox, min(ox + tw, w), 32)]


def _sorted_warp_lists(vals, starts, glob, h, w):
    """(x0, y0, ids) of every live warp of the sorted kernel, one sample:
    the tile's range, then the global list."""
    glob_ids = glob[1:1 + int(glob[0])]
    for t in range(starts.shape[0] - 1):
        ids = torch.cat([vals[int(starts[t]):int(starts[t + 1])], glob_ids])
        for x0, y0 in _tile_rects(t, h, w):
            yield x0, y0, ids


def _topk_warp_lists(lists, counts, h, w):
    """(x0, y0, ids) of every live warp of the top-k kernel, one sample:
    the tile's capped list."""
    for t in range(counts.shape[0]):
        for x0, y0 in _tile_rects(t, h, w):
            yield x0, y0, lists[t, :int(counts[t])]


def _cols_warp_lists(face_ids, starts, glob_col, h, w):
    """(x0, y0, ids) of every live warp of the cols kernel, one sample:
    four warps to an 8x128 sub-tile (column-major ids), each with the
    sub-tile's range, then its column's global range."""
    n_subs, n_cols = -(-h // 8), -(-w // 128)
    gids = glob_col[n_cols + 1:]
    for xi in range(n_cols):
        glob_ids = gids[int(glob_col[xi]):int(glob_col[xi + 1])]
        for sub in range(n_subs):
            t = xi * n_subs + sub
            ids = torch.cat([face_ids[int(starts[t]):int(starts[t + 1])], glob_ids])
            for x0 in range(xi * 128, min(xi * 128 + 128, w), 32):
                yield x0, sub * 8, ids


WARP_LISTS = {"sorted": _sorted_warp_lists, "cols": _cols_warp_lists,
              "topk": _topk_warp_lists}
PLAIN = {"sorted": rc.raster_sorted_ref, "cols": rc.raster_cols_ref,
         "topk": rc.raster_topk_ref}


def _culled_walk(kernel, params, *binned_h_w):
    """The shared walk of the three kernels (csrc/raster_common.cuh) in
    plain PyTorch: per 32x8 warp rectangle, the faces ``kernel`` lists for it,
    culled by _cull_keeps, then the strict-'>' walk (as a first maximum);
    pixels of no live warp, or whose warp keeps no face, stay background."""
    *binned, h, w = binned_h_w
    z, r, g, bl = torch.zeros((4, params.shape[0], h, w))
    f32 = lambda v: torch.tensor(v + 0.5)  # noqa: E731
    for s in range(params.shape[0]):
        for x0, y0, ids in WARP_LISTS[kernel](*(a[s] for a in binned), h, w):
            q = params[s, ids.long()]
            x1, y1 = min(x0 + 31, w - 1), min(y0 + 7, h - 1)
            qk = q[_cull_keeps(q, f32(x0), f32(x1), f32(y0), f32(y1))][:, None]
            if qk.shape[0] == 0:
                continue
            xs = torch.arange(x0, x1 + 1, dtype=torch.float32) + 0.5
            ys = torch.arange(y0, y1 + 1, dtype=torch.float32) + 0.5
            px, py = (a.reshape(1, -1) for a in torch.meshgrid(xs, ys, indexing="xy"))
            inside = ((_plane(qk, 0, px, py) >= 0) & (_plane(qk, 3, px, py) >= 0)
                      & (_plane(qk, 6, px, py) >= 0))
            zz, win = torch.where(inside, _plane(qk, 9, px, py), 0.0).max(0)
            pw = qk[win, 0]  # (P, 24)
            hit = zz > 0
            acc = [torch.where(hit, a, 0.0).reshape(y1 - y0 + 1, x1 - x0 + 1)
                   for a in (zz, *(_plane(pw, i, px[0], py[0]) for i in (12, 15, 18)))]
            for out, a in zip((z, r, g, bl), acc):
                out[s, y0:y1 + 1, x0:x1 + 1] = a
    return rc._finish(z, r, g, bl)


# Frames for the adversarial faces: 50x70 clips tiles, sub-tiles and warp
# rectangles on both axes; 64x160 and 40x330 leave the cols kernel's last
# 128-px column one whole warp and (40x330) one clipped to 10 columns, the
# rest of it outside the image.
WALK_FRAMES = ((50, 70), (64, 160), (40, 330))


def _walk_binnings(kernel, bbox, ok, size, on_mesh):
    """The binned inputs of ``kernel`` to check at one frame: every span
    the port uses (sorted), the one packed binning (cols), caps that drop
    faces and one that does not (top-k)."""
    if kernel == "sorted":
        return [rc.bin_faces_sorted(bbox, ok, size, *spans)
                for spans in (((4, 2), (8, 3), (2, 1)) if on_mesh else ((1, 1),))]
    if kernel == "cols":
        return [rc.bin_faces_packed(bbox, ok, size)]
    binned = [rc.bin_faces_topk(bbox, ok, size, cap) for cap in (8, 48, 512)]
    assert bool((binned[0][1] == 8).any())  # some tiles drop faces
    return binned


def _check_culled_walk(kernel, mesh, seed, cull):
    # The kernel's cull and walk order, emulated, give the plain version's
    # output bit for bit on a mesh and on the cull's adversarial faces.
    (_, _, _), (params, bbox, ok) = _pack_both(mesh, _poses(2, seed, 0.45), cull)
    cases = [(*map(torch.from_numpy, (params, bbox, ok)), (H, W), True)]
    p, bb = _cull_faces(seed)
    frames = WALK_FRAMES[:1] if kernel == "sorted" else WALK_FRAMES
    cases += [(p, bb, torch.ones(p.shape[:2], dtype=torch.bool), f, False) for f in frames]
    for p, bb, o, (h, w), on_mesh in cases:
        for binned in _walk_binnings(kernel, bb, o, (h, w), on_mesh):
            want = PLAIN[kernel](p, *binned, h, w)
            got = _culled_walk(kernel, p, *binned, h, w)
            assert (want[1] > 0).any()
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("mesh,seed,cull", CASES)
def test_sorted_culled_walk_matches_plain_bit_for_bit(mesh, seed, cull):
    _check_culled_walk("sorted", mesh, seed, cull)


@pytest.mark.parametrize("mesh,seed,cull", CASES)
def test_cols_culled_walk_matches_plain_bit_for_bit(mesh, seed, cull):
    _check_culled_walk("cols", mesh, seed, cull)


@pytest.mark.parametrize("mesh,seed,cull", CASES)
def test_topk_culled_walk_matches_plain_bit_for_bit(mesh, seed, cull):
    _check_culled_walk("topk", mesh, seed, cull)


def test_cols_walk_lists_every_live_warp():
    # At 40x330 the cols kernel's third column is 74 pixels wide: two whole
    # warp rectangles, one clipped to 10 columns, one outside the image.
    # Every live warp, and no other, gets a list, and the adversarial
    # faces' huge ones put a global range behind the third column's.
    p, bb = _cull_faces(0)
    face_ids, starts, glob = rc.bin_faces_packed(bb, torch.ones(p.shape[:2], dtype=torch.bool),
                                                 (40, 330))
    assert int(glob[0, 3]) > int(glob[0, 2]) > 0  # the third column's global range
    lists = list(_cols_warp_lists(face_ids[0], starts[0], glob[0], 40, 330))
    assert len(lists) == 5 * 11  # 5 sub-tile rows x (4 + 4 + 3) live warps
    assert max(x0 for x0, _, _ in lists) == 320
    n_glob = int(glob[0, 3] - glob[0, 2])
    assert all(len(ids) >= n_glob for x0, _, ids in lists if x0 >= 256)


@pytest.mark.parametrize("kernel", ["sorted", "cols", "topk"])
def test_empty_lists_give_background(kernel):
    # One small face in the top-left corner of a 64x300 frame: every other
    # sub-tile and tile has an empty range (and there is no global list),
    # and a top-k tile a zero count; their pixels come out as background,
    # in the plain version and in the emulated walk alike.
    xy = torch.tensor([[2.0, 1.0], [9.0, 2.0], [4.0, 6.0]])
    corners = tuple((xy[None, None, i, 0], xy[None, None, i, 1]) for i in range(3))
    one = torch.ones((1, 1))
    params, bbox, ok = rc._plane_pack(corners, (one, one, one), ((one,) * 3,) * 3,
                                      torch.ones((1, 1), dtype=torch.bool))
    h, w = 64, 300
    binned = {"sorted": lambda: rc.bin_faces_sorted(bbox, ok, (h, w)),
              "cols": lambda: rc.bin_faces_packed(bbox, ok, (h, w)),
              "topk": lambda: rc.bin_faces_topk(bbox, ok, (h, w), 4)}[kernel]()
    ranges = binned[1]  # starts, or the top-k counts
    assert int(ranges.max()) == 1 and int((ranges == 0).sum()) >= 1
    want = PLAIN[kernel](params, *binned, h, w)
    got = _culled_walk(kernel, params, *binned, h, w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    rgb, depth = got
    assert (depth[0, :8, :16] > 0).any()
    assert not depth[0, 8:].any() and not depth[0, :, 16:].any()
    assert not rgb[0, :, 8:].any() and not rgb[0, :, :, 16:].any()


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
    rgb, depth = rc.raster_topk(params, *rc.bin_faces_topk(bbox, ok, (16, 16), 4), 16, 16)
    assert rgb.shape == (1, 3, 16, 16) and not depth.any()
    assert rc.LAUNCHES == {"raster_cols": 0, "raster_sorted": 0, "raster_topk": 0,
                           "cols_fallback": 0}
    meta = [t.to("meta") for t in (params, *rc.bin_faces_packed(bbox, ok, (16, 16)))]
    with pytest.raises(ValueError):
        rc.raster_cols(*meta, 16, 16)
    meta = [t.to("meta") for t in (params, *rc.bin_faces_sorted(bbox, ok, (16, 16)))]
    with pytest.raises(ValueError):
        rc.raster_sorted(*meta, 16, 16)
    meta = [t.to("meta") for t in (params, *rc.bin_faces_topk(bbox, ok, (16, 16), 4))]
    with pytest.raises(ValueError):
        rc.raster_topk(*meta, 16, 16)


def test_dispatch_refuses_unported_routes():
    # Every reference route is ported; an unknown binning, or a tile the
    # CUDA kernels are not built for, is refused.
    params = torch.zeros((1, 8, 24))
    bbox = torch.zeros((1, 8, 4))
    ok = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="binning"):
        rc._render_dispatch(params, bbox, ok, (16, 16), "bogus")
    tri = [torch.zeros((1, 9, 4)) for _ in range(3)]
    pose = torch.from_numpy(_poses(1, 0))
    with pytest.raises(ValueError, match="binning"):
        rc.render_batch_tri(*tri, pose, torch.from_numpy(K[None]), (16, 16), binning="top_k")
    with pytest.raises(ValueError, match="tile"):
        rc.render_batch_tri(*tri, pose, torch.from_numpy(K[None]), (16, 16), tile=(16, 128))


def test_light_direction_takes_tensors():
    # A Lighting whose fields are tensors (as random_lighting draws them on
    # the device) packs like the tuple-valued one, and like the reference's
    # array-valued Lighting.
    mesh, seed, cull = CASES[0]
    poses = _poses(2, seed, 0.45)
    tri = _tri(mesh, 2)
    ks = np.broadcast_to(K, (2, 3, 3)).copy()
    amb, dif, d = LIT
    lit_t = raster_ref.Lighting(torch.tensor(amb), torch.tensor(dif), torch.tensor(d))
    args = [torch.from_numpy(a) for a in (*tri, poses, ks)]
    got = rc.pack_tri_params(*args, lit_t, 0.01)
    want = rc.pack_tri_params(*args, _lighting(False), 0.01)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    (pj, _, _), _ = _pack_both(mesh, poses, False)
    scale = np.abs(pj).max(axis=(0, 1), keepdims=True) + 1e-6
    np.testing.assert_allclose(got[0].numpy() / scale, pj / scale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cap", [8, 512])
@pytest.mark.parametrize("mesh,seed,cull", CASES)
def test_topk_binning_equal_as_integers(mesh, seed, cull, cap):
    # Counts equal; each tile's first `count` ids equal (the rest is never
    # walked, so its content is free).
    (_, bbox, ok), _ = _pack_both(mesh, _poses(2, seed, 0.45), cull)
    k = min(cap, mesh.num_faces)
    ref_l, ref_c = jax.vmap(lambda bb, o: rp.bin_faces(bb, o, (H, W), (32, 256), k))(
        jnp.asarray(bbox), jnp.asarray(ok))
    lists, counts = rc.bin_faces_topk(torch.from_numpy(bbox), torch.from_numpy(ok), (H, W), cap)
    assert lists.dtype == counts.dtype == torch.int32
    ref_l = np.asarray(ref_l).reshape(lists.shape)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_c).reshape(counts.shape))
    head = np.arange(k) < counts.numpy()[..., None]
    np.testing.assert_array_equal(np.where(head, lists.numpy(), -1), np.where(head, ref_l, -1))
    if cap == 8:
        assert (counts.numpy() == 8).any()  # some tiles drop faces


@pytest.mark.parametrize("mesh,seed,cull,cap", [(*CASES[0], 48), (*CASES[1], 120)])
def test_topk_plain_matches_interpret_with_drops(mesh, seed, cull, cap):
    # At 64x128 there are two 32x256 tiles, each crossed by more than `cap`
    # faces (64-83 for the sphere, 138-160 for the torus): the cap drops
    # faces, and both packages drop the same.
    poses = _poses(2, seed, 0.45)
    tri = _tri(mesh, 2)
    ks = np.broadcast_to(K, (2, 3, 3)).copy()
    cd = np.full((2,), cull_direction(mesh) if cull else 0.0, np.float32)
    with pytest.warns(RuntimeWarning, match="DROPS"):
        rgb_j, d_j = rp.render_batch_tri(*map(jnp.asarray, (*tri, poses, ks)), (H, W),
                                         lighting=_lighting(True), interpret=True,
                                         binning="topk", max_faces_per_tile=cap,
                                         cull_dir=jnp.asarray(cd))
    args = [torch.from_numpy(a) for a in (*tri, poses, ks)]
    rc.reset_launches()
    with pytest.warns(RuntimeWarning, match="DROPS"):
        rgb_t, d_t = rc.render_batch_tri(*args, (H, W), lighting=_lighting(False),
                                         binning="topk", max_faces_per_tile=cap,
                                         cull_dir=torch.from_numpy(cd))
    assert rc.LAUNCHES["raster_topk"] == 0  # CPU: the plain version
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)
    _, d_full = rc.render_batch_tri(*args, (H, W), lighting=_lighting(False),
                                    binning="sort", cull_dir=torch.from_numpy(cd))
    assert ((d_full.numpy() > 0) & (d_t.numpy() == 0)).any()  # the drops leave holes


@pytest.mark.parametrize("binning", ["auto", "cols", "sort", "topk"])
def test_chunked_dispatch_matches_reference(monkeypatch, binning):
    # Chunks of 500 faces over a 1,280-face sphere: 500 + 500 + 280, each
    # chunk picking its own "auto" route (cols from 400 faces here), then
    # z-merged in order.  Both modules are patched alike.
    for mod in (rc, rp):
        monkeypatch.setattr(mod, "_FACE_CHUNK", 500)
        monkeypatch.setattr(mod, "_COLS_MIN_FACES", 400)
    mesh = icosphere_mesh(radius=0.08, subdivisions=3)
    (pj, bj, okj), (pt, bt, okt) = _pack_both(mesh, _poses(2, 4, 0.45), True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the top-k route warns
        rgb_j, d_j = rp._render_dispatch(*map(jnp.asarray, (pj, bj, okj)), (H, W),
                                         (32, 256), 64, True, binning)
        rc.reset_launches()
        rgb_t, d_t = rc._render_dispatch(*map(torch.from_numpy, (pt, bt, okt)), (H, W),
                                         binning, max_faces_per_tile=64)
    assert d_t.shape == (2, H, W)
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)


def test_zmerge_earlier_chunk_wins_ties():
    d_a = torch.tensor([[[0.0, 0.5, 0.5, 0.7]]])
    d_b = torch.tensor([[[0.3, 0.5, 0.0, 0.6]]])
    rgb_a, rgb_b = torch.zeros((1, 3, 1, 4)), torch.ones((1, 3, 1, 4))
    rgb, d = rc._zmerge_nchw((rgb_a, d_a), (rgb_b, d_b))
    torch.testing.assert_close(d, torch.tensor([[[0.3, 0.5, 0.5, 0.6]]]))
    torch.testing.assert_close(rgb[0, 0, 0], torch.tensor([1.0, 0.0, 0.0, 1.0]))


def _two_meshes_padded():
    a = mesh_t.pad_mesh(mesh_t.torus_mesh(), 300, 600)
    b = mesh_t.pad_mesh(mesh_t.icosphere_mesh(0.06, subdivisions=2), 300, 600)
    return a, b


@pytest.mark.parametrize("layout", ["shared", "per_sample_vertices", "per_sample_faces"])
def test_render_batch_layouts_match(layout):
    # The vertex+faces entry point for its three mesh layouts.
    a, b = _two_meshes_padded()
    poses = _poses(2, 7, 0.45)
    ks = np.broadcast_to(K, (2, 3, 3)).copy()
    if layout == "shared":
        arrays = (a.vertices, a.faces, a.colors, a.normals)
    elif layout == "per_sample_vertices":
        arrays = (np.stack([a.vertices, 1.2 * a.vertices]), a.faces,
                  np.stack([a.colors, a.colors[:, ::-1]]), np.stack([a.normals] * 2))
    else:
        arrays = tuple(np.stack([getattr(m, f) for m in (a, b)])
                       for f in ("vertices", "faces", "colors", "normals"))
    rgb_j, d_j = rp.render_batch(*map(jnp.asarray, (*arrays, poses, ks)), (H, W),
                                 lighting=_lighting(True), interpret=True)
    rgb_t, d_t = rc.render_batch(*map(torch.from_numpy, (*arrays, poses, ks)), (H, W),
                                 lighting=_lighting(False))
    assert rgb_t.shape == (2, H, W, 3)
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)


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
