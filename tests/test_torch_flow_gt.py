"""deepim_tpu_torch.ops.flow_gt.calc_flow (batched) against the reference's
calc_flow (vmapped), and the nearest-neighbour sampler under it (float32,
CPU).

Inputs from a numpy seed: a foreground blob of rendered depth, a relative
pose of a few degrees and centimetres, and an observed depth that occludes
part of the object.  Flow agrees to atol 1e-4 pixels (float32 products in
another order), ``valid`` exactly, at occlusion strides 1, 2 and 4 on
sizes that are not multiples of the stride (the edge-extended border).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.geometry import rotations as rot_j
from deepim_tpu.ops import flow_gt as flow_j
from deepim_tpu.ops.resample import nearest_sample as nearest_j
from deepim_tpu_torch.ops.flow_gt import calc_flow
from deepim_tpu_torch.ops.resample import nearest_sample

B = 3


def _inputs(h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    depth_src = np.zeros((B, h, w), np.float32)
    depth_tgt = np.zeros((B, h, w), np.float32)
    for i in range(B):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        blob = (yy - cy) ** 2 / (0.3 * h) ** 2 + (xx - cx) ** 2 / (0.3 * w) ** 2 < 1
        depth_src[i] = np.where(blob, rng.uniform(0.7, 0.8, (h, w)), 0.0)
        occluder = (xx > rng.uniform(0.4, 0.6) * w) & blob
        depth_tgt[i] = np.where(occluder, 0.5, np.where(blob, 0.75, 0.0))
    q = (np.array([1.0, 0, 0, 0]) + 0.05 * rng.randn(2 * B, 4)).astype(np.float32)
    r = np.asarray(rot_j.quat2mat(jnp.asarray(q)))
    t = np.stack([rng.uniform(-0.02, 0.02, 2 * B), rng.uniform(-0.02, 0.02, 2 * B),
                  rng.uniform(0.7, 0.8, 2 * B)], -1)
    poses = np.concatenate([r, t[..., None]], -1).astype(np.float32)
    k = np.broadcast_to(np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                                 np.float32), (B, 3, 3)).copy()
    return depth_src, poses[:B], poses[B:], k, depth_tgt


@pytest.mark.parametrize("size,stride", [
    ((48, 64), 1), ((50, 70), 2), ((50, 70), 4), ((47, 61), 4), ((48, 64), 4)])
def test_calc_flow_matches_reference(size, stride):
    ds, ps, pt, k, dt = _inputs(*size, seed=stride)
    for tgt in (None, dt):
        def one(a, b, c, kk, d):
            return flow_j.calc_flow(a, b, c, kk, d, occlusion_stride=stride)

        if tgt is None:
            flow_r, valid_r = jax.vmap(lambda a, b, c, kk: flow_j.calc_flow(a, b, c, kk))(
                *map(jnp.asarray, (ds, ps, pt, k)))
            flow, valid = calc_flow(*map(torch.from_numpy, (ds, ps, pt, k)))
        else:
            flow_r, valid_r = jax.vmap(one)(*map(jnp.asarray, (ds, ps, pt, k, tgt)))
            flow, valid = calc_flow(*map(torch.from_numpy, (ds, ps, pt, k, tgt)),
                                    occlusion_stride=stride)
        assert flow.shape == (B, *size, 2) and valid.dtype == torch.bool
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
        np.testing.assert_allclose(flow.numpy(), np.asarray(flow_r), rtol=0, atol=1e-4)
        assert np.abs(np.asarray(flow_r)).max() > 1.0
    # The occluder removes part of the foreground.
    fg = ds > 0
    assert 0 < valid.sum() < fg.sum()


def test_nearest_sample_matches_reference():
    rng = np.random.RandomState(1)
    img = rng.rand(2, 9, 13, 3).astype(np.float32)
    coords = np.concatenate([rng.uniform(-2, 15, (2, 40, 2)),
                             # pixel edges: round half to even, bounds on the index
                             np.array([[[0.0, 0.0], [1.0, 2.0], [13.0, 9.0], [12.5, 8.5],
                                        [-0.01, 3.0], [2.0, 9.49]]] * 2)], 1
                            ).astype(np.float32)
    ref = jax.vmap(lambda a, c: nearest_j(a, c, fill_value=-1.0))(
        jnp.asarray(img), jnp.asarray(coords))
    got = nearest_sample(torch.from_numpy(img), torch.from_numpy(coords), fill_value=-1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # one image, no batch dims, as the reference's signature
    np.testing.assert_array_equal(
        nearest_sample(torch.from_numpy(img[0]), torch.from_numpy(coords[0])).numpy(),
        np.asarray(nearest_j(jnp.asarray(img[0]), jnp.asarray(coords[0]))))
