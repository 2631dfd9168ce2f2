"""deepim_tpu_torch.refine.refine_poses against deepim_tpu's (CPU).

Both packages refine the same numpy inputs with the same flax weights
(carried over by models/bridge.py, pose heads randomised so poses move),
float32 on both sides; the reference renders with its Pallas kernels in
interpret mode.  Whole trajectories (return_all) agree to atol 1e-3: a
pixel on a triangle edge can fall the other way in the two rasterizers,
which nudges the network's output slightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.models import flownet as fn_j
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu_torch.models import flownet as fn_t
from deepim_tpu_torch.models.bridge import flax_to_torch
from deepim_tpu_torch.raster import raster_cuda
from deepim_tpu_torch.refine import refiner as ref_t

OUT = (48, 64)
K = np.array([[150.0, 0, 80.0], [0, 150.0, 60.0], [0, 0, 1]], np.float32)
B = 3


def _meshes(dense):
    sphere = mesh_j.icosphere_mesh(0.05, subdivisions=3 if dense else 2)
    return [mesh_j.box_mesh((0.08, 0.1, 0.06)), sphere, mesh_j.torus_mesh()]


def _inputs(seed):
    rng = np.random.RandomState(seed)
    poses = []
    for _ in range(B):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        t = [rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04), rng.uniform(0.6, 0.9)]
        poses.append(np.concatenate([r, np.asarray(t)[:, None]], 1))
    obs = rng.rand(B, 120, 160, 3)
    cls = np.arange(B) % 3
    return (np.asarray(poses, np.float32), obs.astype(np.float32),
            np.broadcast_to(K, (B, 3, 3)).copy(), cls.astype(np.int32))


def _weights(seed=0, scale=0.02):
    grid = fn_j.bottleneck_grid(*OUT)
    mj = fn_j.DeepIMFlowNet(num_classes=3, dtype=jnp.float32, with_flow=False,
                            with_mask=False, head_grid=grid)
    var = mj.init(jax.random.PRNGKey(seed), jnp.zeros((1, *OUT, 6)))
    params = jax.tree.map(np.asarray, var["params"])
    rng = np.random.RandomState(seed)
    for head in ("fc_rot", "fc_trans"):
        params[head] = {k: (v + scale * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in params[head].items()}
    mt = fn_t.DeepIMFlowNet(num_classes=3, head_grid=grid, dtype=torch.float32)
    mt.load_state_dict(flax_to_torch(params))
    return mj, {"params": params}, mt


@pytest.mark.parametrize("dense,coarse,route", [
    (True, 0, "cols"),  # 1,280 faces >= 1,024: the cols kernel
    (False, 0, "sort"),  # 320 faces: the sorted kernel, spans (8, 3)
    (True, 1, "cols"),  # one coarse iteration at half size first
])
def test_trajectories_match_reference(dense, coarse, route):
    meshes = _meshes(dense)
    init, obs, ks, cls = _inputs(seed=3)
    mj, var, mt = _weights()
    traj_j = ref_j.refine_poses(
        var, mj, ref_j.build_assets(meshes, num_points=64), jnp.asarray(obs),
        jnp.asarray(init), jnp.asarray(ks), jnp.asarray(cls), num_iters=2,
        out_size=OUT, renderer="pallas_interpret", return_all=True,
        coarse_iters=coarse)
    raster_cuda.reset_launches()
    traj_t = ref_t.refine_poses(
        mt, ref_t.build_assets(meshes, num_points=64, device="cpu"), torch.from_numpy(obs),
        torch.from_numpy(init), torch.from_numpy(ks), torch.from_numpy(cls),
        num_iters=2, out_size=OUT, return_all=True, coarse_iters=coarse)
    traj_j = np.asarray(traj_j)
    assert traj_t.shape == traj_j.shape == (3, B, 3, 4)
    moved = np.abs(traj_j[-1] - traj_j[0]).max()
    assert moved > 1e-2, moved  # the randomised heads move the poses
    np.testing.assert_allclose(traj_t.numpy(), traj_j, rtol=0, atol=1e-3)
    assert route == ("cols" if meshes[1].num_faces >= raster_cuda._COLS_MIN_FACES_CROP
                     else "sort")


def test_identity_heads_pass_poses_through():
    init, obs, ks, cls = _inputs(seed=4)
    mt = fn_t.DeepIMFlowNet(num_classes=3, input_size=OUT, dtype=torch.float32)
    out = ref_t.refine_poses(
        mt, ref_t.build_assets(_meshes(False), num_points=16, device="cpu"),
        torch.from_numpy(obs),
        torch.from_numpy(init), torch.from_numpy(ks), torch.from_numpy(cls),
        num_iters=2, out_size=OUT)
    np.testing.assert_allclose(out.numpy(), init, atol=1e-5)
    with pytest.raises(ValueError):  # coarse-to-fine needs a head_grid
        ref_t.refine_poses(mt, ref_t.build_assets(_meshes(False), num_points=16, device="cpu"),
                           torch.from_numpy(obs), torch.from_numpy(init),
                           torch.from_numpy(ks), torch.from_numpy(cls),
                           num_iters=2, out_size=OUT, coarse_iters=1)


def test_build_network_inputs_match():
    meshes = _meshes(False)
    init, obs, ks, cls = _inputs(seed=5)
    mj, _, mt = _weights()
    ni_j = ref_j.build_network_inputs(
        mj, ref_j.gather_class(ref_j.build_assets(meshes, num_points=16), jnp.asarray(cls)),
        jnp.asarray(obs), jnp.asarray(init), jnp.asarray(ks), OUT,
        renderer="pallas_interpret")
    ni_t = ref_t.build_network_inputs(
        mt, ref_t.gather_class(ref_t.build_assets(meshes, num_points=16, device="cpu"),
                               torch.from_numpy(cls)),
        torch.from_numpy(obs), torch.from_numpy(init), torch.from_numpy(ks), OUT)
    np.testing.assert_allclose(ni_t.k_zoom.numpy(), np.asarray(ni_j.k_zoom),
                               rtol=1e-5, atol=1e-3)
    for got, ref in ((ni_t.x, ni_j.x), (ni_t.ren_depth, ni_j.ren_depth)):
        close = np.isclose(got.numpy(), np.asarray(ref), atol=2e-2)
        assert close.mean() > 0.998, 1 - close.mean()


def test_textured_assets_refuse_to_render():
    # Textured sets render through the deferred-texture pass (their
    # trajectories: tests/test_torch_textured.py).  Refused: texturing a set
    # with no texture.  use_textures=False bakes colours into the plain path.
    meshes = [mesh_j.texturize(mesh_j.box_mesh(), seed=1), mesh_j.torus_mesh()]
    with pytest.raises(ValueError, match="no mesh has a texture"):
        ref_t.build_assets([mesh_j.torus_mesh()], num_points=16, use_textures=True, device="cpu")
    init = torch.from_numpy(_inputs(seed=7)[0])
    ks = torch.tensor([[60.0, 0, OUT[1] / 2], [0, 60.0, OUT[0] / 2], [0, 0, 1]]).expand(B, 3, 3)
    cls = torch.tensor([0, 1, 0])
    crops = {}
    for use in (True, False):
        assets = ref_t.build_assets(meshes, num_points=16, use_textures=use, device="cpu")
        assert assets.textured == use
        crops[use] = ref_t.render_crops(ref_t.gather_class(assets, cls), init, ks, OUT)
    for rgb, depth in crops.values():
        assert rgb.shape == (B, *OUT, 3) and (depth > 0).any()
    torch.testing.assert_close(crops[True][1], crops[False][1], rtol=0, atol=0)
    assert not torch.equal(crops[True][0], crops[False][0])
