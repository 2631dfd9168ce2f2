"""deepim_tpu_torch.raster.textured and the textured refine loop against
deepim_tpu (CPU).

The samplers agree to float rounding (atol 1e-6); the deferred-texture
renders to the repo's raster tolerance (``_compare``: at most 0.2 % of
pixels off at rgb atol 2e-2, depth atol 1e-3), with the reference's
Pallas kernels in interpret mode; textured ``refine_poses`` trajectories
to atol 1e-3, as the untextured ones.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.raster import textured as tx_j
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu_torch.raster import textured as tx_t
from deepim_tpu_torch.refine import refiner as ref_t
from test_torch_raster import H, K, W, _compare, _lighting, _poses
from test_torch_refine import B as REFINE_B
from test_torch_refine import OUT, _inputs, _weights


@pytest.mark.parametrize("seed", [0, 1])
def test_samplers_match(seed):
    rng = np.random.RandomState(seed)
    tex = rng.rand(3, 16, 24, 3).astype(np.float32)
    u, v = (rng.uniform(-0.2, 1.2, (2, 10, 12)).astype(np.float32) for _ in range(2))
    idx = np.array([2, 0], np.int32)
    got = tx_t.sample_texture_bilinear(*map(torch.from_numpy, (tex[1], u, v)))
    want = tx_j.sample_texture_bilinear(*map(jnp.asarray, (tex[1], u, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    got = tx_t.sample_texture_atlas(*map(torch.from_numpy, (tex, idx, u, v)))
    want = tx_j.sample_texture_atlas(*map(jnp.asarray, (tex, idx, u, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # The atlas sampler is the per-sample sampler at an offset.
    one = tx_t.sample_texture_bilinear(torch.from_numpy(tex[2]), *map(torch.from_numpy, (u[0], v[0])))
    torch.testing.assert_close(got[0], one, rtol=0, atol=0)


@pytest.mark.parametrize("b,chunk", [(5, 2), (4, 2), (3, 8), (3, 0)])
def test_map_batch_chunks_equals_unchunked(b, chunk):
    rng = np.random.RandomState(b)
    x, y = rng.rand(b, 4, 3).astype(np.float32), rng.rand(b, 4).astype(np.float32)

    def fn(p, q):
        return p * 2.0 + q[..., None]

    got = tx_t._map_batch_chunks(fn, chunk, torch.from_numpy(x), torch.from_numpy(y))
    want = tx_j._map_batch_chunks(fn, chunk, jnp.asarray(x), jnp.asarray(y))
    assert got.shape == (b, 4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), fn(x, y))


def test_tri_uv_corner_major_matches():
    m = mesh_j.texturize(mesh_j.torus_mesh(), seed=4)
    np.testing.assert_array_equal(tx_t.tri_uv_corner_major(m), tx_j.tri_uv_corner_major(m))
    with pytest.raises(ValueError):
        tx_t.tri_uv_corner_major(mesh_j.torus_mesh())


def _textured_inputs(b=2):
    m = mesh_j.texturize(mesh_j.icosphere_mesh(0.08, subdivisions=2), seed=3)
    tri_pos = np.broadcast_to(m.vertices[m.faces].reshape(-1, 9).T, (b, 9, m.num_faces))
    tri_nrm = np.broadcast_to(m.normals[m.faces].reshape(-1, 9).T, (b, 9, m.num_faces))
    tri_uv = np.broadcast_to(tx_j.tri_uv_corner_major(m), (b, 6, m.num_faces))
    arrays = [np.ascontiguousarray(a) for a in (tri_pos, tri_uv, tri_nrm)]
    return arrays + [_poses(b, 5, 0.45), np.broadcast_to(K, (b, 3, 3)).copy()]


@pytest.mark.parametrize("kind,binning", [
    ("shared", "auto"), ("per_sample", "cols"), ("atlas", "sort"), ("atlas", "topk")])
def test_render_batch_textured_matches(kind, binning):
    arrays = _textured_inputs()
    tex = np.stack([mesh_j.procedural_texture(s, (32, 32)) for s in (1, 2, 3)])
    texture, idx = {"shared": (tex[0], None), "per_sample": (tex[:2], None),
                    "atlas": (tex, np.array([2, 1], np.int32))}[kind]
    kw = {"binning": binning, "max_faces_per_tile": 96, "deferred_chunk": 1}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the top-k route warns
        rgb_j, d_j = tx_j.render_batch_textured(
            *map(jnp.asarray, arrays), (H, W), jnp.asarray(texture),
            lighting=_lighting(True), interpret=True,
            tex_idx=None if idx is None else jnp.asarray(idx), **kw)
        rgb_t, d_t = tx_t.render_batch_textured(
            *map(torch.from_numpy, arrays), (H, W), torch.from_numpy(texture),
            lighting=_lighting(False),
            tex_idx=None if idx is None else torch.from_numpy(idx), **kw)
    assert rgb_t.shape == (2, H, W, 3)
    assert not rgb_t.numpy()[d_t.numpy() == 0].any()  # background stays 0
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)


@pytest.mark.parametrize("dense,route", [
    (True, "cols"),  # 1,280-face sphere: the cols kernel under the deferred pass
    (False, "sort"),  # 320 faces: the sorted kernel
])
def test_textured_trajectories_match_reference(dense, route):
    meshes = [mesh_j.box_mesh((0.08, 0.1, 0.06)),
              mesh_j.icosphere_mesh(0.05, subdivisions=3 if dense else 2),
              mesh_j.torus_mesh()]
    meshes = [mesh_j.texturize(m, seed=i, size=(32, 32)) for i, m in enumerate(meshes)]
    init, obs, ks, cls = _inputs(seed=6)
    mj, var, mt = _weights(seed=1)
    assets_j = ref_j.build_assets(meshes, num_points=64)
    assets_t = ref_t.build_assets(meshes, num_points=64, device="cpu")
    assert assets_t.textured and assets_j.textured
    traj_j = ref_j.refine_poses(
        var, mj, assets_j, jnp.asarray(obs), jnp.asarray(init), jnp.asarray(ks),
        jnp.asarray(cls), num_iters=2, out_size=OUT, renderer="pallas_interpret",
        return_all=True)
    traj_t = ref_t.refine_poses(
        mt, assets_t, torch.from_numpy(obs), torch.from_numpy(init), torch.from_numpy(ks),
        torch.from_numpy(cls), num_iters=2, out_size=OUT, return_all=True)
    traj_j = np.asarray(traj_j)
    assert traj_t.shape == traj_j.shape == (3, REFINE_B, 3, 4)
    assert np.abs(traj_j[-1] - traj_j[0]).max() > 1e-2  # the poses move
    np.testing.assert_allclose(traj_t.numpy(), traj_j, rtol=0, atol=1e-3)
    assert (meshes[1].num_faces >= 1024) == (route == "cols")
