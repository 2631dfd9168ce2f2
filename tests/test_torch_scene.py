"""deepim_tpu_torch's scene render and on-device synthesis against deepim_tpu
(CPU).

``render_scene`` (untextured and textured, with ``valid`` masking, whole
and in face chunks) is held to the reference's ``render_scene`` with its
Pallas kernels in interpret mode, at the repo's raster tolerance
(``_compare``: at most 0.2 % of pixels off at rgb atol 2e-2, depth atol
1e-3).  The two packages draw different random numbers, so the synthesis
checks draw a batch from the port, draw the same scene again from a
generator of the same seed, and render that scene with the reference's
functions: depth, visible mask and visible fraction must agree.  The
reference's per-object "xla" merge is a second, brute-force oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.raster import raster_pallas as rp
from deepim_tpu.raster import raster_xla
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu_torch.data import synthetic as syn_t
from deepim_tpu_torch.raster import raster_cuda as rc
from deepim_tpu_torch.raster import raster_ref
from deepim_tpu_torch.refine import refiner as ref_t
from test_torch_raster import _compare, _euler

SIZE = (48, 64)
K = np.array([[110.0, 0, 32.0], [0, 110.0, 24.0], [0, 0, 1]], np.float32)


def _meshes(textured):
    meshes = [mesh_j.box_mesh((0.12, 0.1, 0.06)), mesh_j.icosphere_mesh(0.05, subdivisions=2),
              mesh_j.torus_mesh()]
    if textured:
        meshes = [mesh_j.texturize(m, seed=i, size=(32, 32)) for i, m in enumerate(meshes)]
    return meshes


def _assets(textured):
    meshes = _meshes(textured)
    return (ref_t.build_assets(meshes, num_points=32, device="cpu"),
            ref_j.build_assets(meshes, num_points=32))


def _scene(seed):
    """Two scenes of three slots: a target and two objects near it."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((2, 3, 3, 4), np.float32)
    for b in range(2):
        for m in range(3):
            t = [rng.uniform(-0.06, 0.06), rng.uniform(-0.04, 0.04), rng.uniform(0.55, 0.8)]
            poses[b, m] = np.concatenate([_euler(*rng.uniform(-1.5, 1.5, 3)),
                                          np.asarray(t)[:, None]], 1)
    cls = np.array([[0, 1, 2], [2, 0, 1]], np.int32)
    return cls, poses


def _lightings(amb=0.5, dif=0.5, d=(0.2, -0.3, -1.0)):
    """The same light as the port's tensor-valued and the reference's
    array-valued Lighting."""
    return (raster_ref.Lighting(torch.tensor(amb), torch.tensor(dif), torch.tensor(d)),
            raster_xla.Lighting(jnp.float32(amb), jnp.float32(dif), jnp.asarray(d, jnp.float32)))


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("chunk", [None, 600])
def test_render_scene_matches_reference(monkeypatch, textured, chunk):
    # chunk=600 splits each scene's 3 x 576 faces into 600 + 600 + 528,
    # z-merged; both modules are patched alike.
    if chunk:
        for mod in (rc, rp):
            monkeypatch.setattr(mod, "_FACE_CHUNK", chunk)
    at, aj = _assets(textured)
    cls, poses = _scene(seed=1)
    valid = np.array([[True, True, False], [True, False, True]])
    ks = np.broadcast_to(K, (2, 3, 3)).copy()
    lit_t, lit_j = _lightings()
    rgb_j, d_j = ref_j.render_scene(aj, *map(jnp.asarray, (cls, poses, valid, ks)), SIZE,
                                    lighting=lit_j, interpret=True)
    rgb_t, d_t = ref_t.render_scene(at, *map(torch.from_numpy, (cls, poses, valid, ks)), SIZE,
                                    lighting=lit_t)
    assert rgb_t.shape == (2, *SIZE, 3) and d_t.shape == (2, *SIZE)
    _compare(rgb_t.numpy(), d_t.numpy(), rgb_j, d_j)
    # The invalid slots render nothing: with every slot on, the scene grows.
    _, d_all = ref_t.render_scene(at, *map(torch.from_numpy, (cls, poses, np.ones_like(valid),
                                                              ks)), SIZE, lighting=lit_t)
    assert ((d_all > 0) & (d_t == 0)).any()


def _xla_merge(aj, scene_cls, scene_poses, ks):
    """The reference's per-object "xla" scene: each slot rendered alone by
    the brute-force renderer, then depth-merged (synthetic.py:139-157)."""
    depths = []
    for j in range(scene_cls.shape[1]):
        ab = ref_j.gather_class(aj, jnp.asarray(scene_cls[:, j]))
        depths.append(np.asarray(ref_j.render_crops(
            ab, jnp.asarray(scene_poses[:, j]), jnp.asarray(ks), SIZE, "xla")[1]))
    big = np.where(np.stack(depths) > 0, np.stack(depths), np.inf)
    return np.where(np.isfinite(big.min(0)), big.min(0), 0.0)


def _jax_lighting(lit):
    return raster_xla.Lighting(*(jnp.asarray(x.numpy()) for x in lit))


@pytest.mark.parametrize("textured", [False, True])
def test_synthetic_batch_draw_then_compare(textured):
    at, aj = _assets(textured)
    k = torch.from_numpy(K)
    batch = syn_t.synthetic_batch(torch.Generator().manual_seed(3), at, 2, k, SIZE,
                                  z_range=(0.45, 0.7))
    g = torch.Generator().manual_seed(3)
    cls, pose_tgt, _ = syn_t._draw_pairs(g, 3, 2, k, SIZE, z_range=(0.45, 0.7))
    lighting = syn_t.random_lighting(g)
    torch.testing.assert_close(cls, batch["class_idx"], rtol=0, atol=0)
    torch.testing.assert_close(pose_tgt, batch["pose_tgt"], rtol=0, atol=0)
    rgb_j, d_j = ref_j.render_crops(
        ref_j.gather_class(aj, jnp.asarray(cls.numpy())), jnp.asarray(pose_tgt.numpy()),
        jnp.asarray(batch["k"].numpy()), SIZE, "pallas_interpret",
        lighting=_jax_lighting(lighting))
    mask = batch["obs_mask"].numpy()
    np.testing.assert_array_equal(mask, batch["obs_depth"].numpy() > 0)
    obs_rgb = batch["obs_rgb"].numpy()
    assert ((obs_rgb >= 0) & (obs_rgb <= 1)).all()
    _compare(np.where(mask[..., None], obs_rgb, 0.0), batch["obs_depth"].numpy(), rgb_j, d_j)
    assert (mask == (np.asarray(d_j) > 0)).mean() > 0.998


@pytest.mark.parametrize("textured", [False, True])
def test_synthetic_occlusion_batch_draw_then_compare(textured):
    at, aj = _assets(textured)
    k = torch.from_numpy(K)
    batch = syn_t.synthetic_occlusion_batch(torch.Generator().manual_seed(5), at, 2, k, SIZE,
                                            num_distractors=2, z_range=(0.55, 0.8))
    s = syn_t._draw_scene(torch.Generator().manual_seed(5), 3, 2, k, SIZE, z_range=(0.55, 0.8))
    torch.testing.assert_close(s["pose_tgt"], batch["pose_tgt"], rtol=0, atol=0)
    scene_cls, scene_poses = s["scene_cls"].numpy(), s["scene_poses"].numpy()
    ks = batch["k"].numpy()
    rgb_j, d_j = ref_j.render_scene(
        aj, jnp.asarray(scene_cls), jnp.asarray(scene_poses), jnp.ones((2, 3), bool),
        jnp.asarray(ks), SIZE, lighting=_jax_lighting(s["lighting"]), interpret=True)
    _, tgt_j = ref_j.render_crops(ref_j.gather_class(aj, jnp.asarray(scene_cls[:, 0])),
                                  jnp.asarray(scene_poses[:, 0]), jnp.asarray(ks), SIZE,
                                  "pallas_interpret")
    d_j, tgt_j = np.asarray(d_j), np.asarray(tgt_j)
    visible_j = (tgt_j > 0) & (d_j >= tgt_j - 1e-4) & (np.abs(d_j - tgt_j) < 5e-3)
    frac_j = visible_j.sum((1, 2)) / np.maximum((tgt_j > 0).sum((1, 2)), 1)

    depth = batch["obs_depth"].numpy()
    scene = depth > 0
    _compare(np.where(scene[..., None], batch["obs_rgb"].numpy(), 0.0), depth, rgb_j, d_j)
    assert (batch["obs_mask"].numpy() == visible_j).mean() > 0.998
    np.testing.assert_allclose(batch["visible_frac"].numpy(), frac_j, rtol=0, atol=0.05)
    assert (frac_j < 0.999).any()  # a distractor hides part of a target
    # The brute-force per-object merge agrees on the scene's depth too.
    close = np.isclose(depth, _xla_merge(aj, scene_cls, scene_poses, ks), atol=1e-3)
    assert close.mean() > 0.995, 1 - close.mean()


def test_random_lighting_draws_on_the_generator():
    a = syn_t.random_lighting(torch.Generator().manual_seed(0))
    b = syn_t.random_lighting(torch.Generator().manual_seed(0))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for seed in range(20):
        lit = syn_t.random_lighting(torch.Generator().manual_seed(seed))
        assert 0.4 <= float(lit.ambient) <= 0.9 and 0.2 <= float(lit.diffuse) <= 0.8
        assert lit.direction.shape == (3,) and float(lit.direction[2]) <= -0.2
        assert lit.direction.device.type == "cpu"
