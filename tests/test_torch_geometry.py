"""deepim_tpu_torch.geometry against deepim_tpu.geometry (float32, CPU).

Same numpy inputs through both packages, atol 1e-5 (float32 rounding of
small products; the reference runs these at Precision.HIGHEST).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.geometry import delta_pose as dp_j
from deepim_tpu.geometry import rotations as rot_j
from deepim_tpu.geometry import se3 as se3_j
from deepim_tpu_torch.geometry import delta_pose as dp_t
from deepim_tpu_torch.geometry import rotations as rot_t
from deepim_tpu_torch.geometry import se3 as se3_t

ATOL = 1e-5
RNG = np.random.RandomState(0)
QUATS = RNG.randn(64, 4).astype(np.float32)
ANGLES = RNG.uniform(-3.0, 3.0, (3, 64)).astype(np.float32)
K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _poses(n, seed):
    rng = np.random.RandomState(seed)
    r = np.asarray(rot_j.quat2mat(jnp.asarray(rng.randn(n, 4).astype(np.float32))))
    t = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(0.3, 1.5, n)], -1).astype(np.float32)
    return np.concatenate([r, t[..., None]], -1)


@pytest.mark.parametrize("fn", ["quat_normalize", "quat2mat"])
def test_quat_functions(fn):
    _close(getattr(rot_t, fn)(torch.from_numpy(QUATS)),
           getattr(rot_j, fn)(jnp.asarray(QUATS)))


def test_mat2quat_all_branches():
    # Rotations near each Shepperd branch (identity and 180° about x/y/z).
    mats = np.asarray(rot_j.quat2mat(jnp.asarray(QUATS)))
    flips = np.stack([np.diag(d).astype(np.float32)
                      for d in ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))])
    mats = np.concatenate([mats, flips, flips @ mats[:4]])
    _close(rot_t.mat2quat(torch.from_numpy(mats)), rot_j.mat2quat(jnp.asarray(mats)))


@pytest.mark.parametrize("fn", ["euler2mat", "euler2quat"])
def test_euler_functions(fn):
    _close(getattr(rot_t, fn)(*map(torch.from_numpy, ANGLES)),
           getattr(rot_j, fn)(*map(jnp.asarray, ANGLES)))


def test_random_quat_unit_and_canonical():
    g = torch.Generator().manual_seed(3)
    q = rot_t.random_quat(g, (256,))
    assert q.shape == (256, 4)
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert (q[:, 0] >= 0).all()
    again = rot_t.random_quat(torch.Generator().manual_seed(3), (256,))
    assert torch.equal(q, again)  # the generator alone fixes the draw


def test_se3_functions():
    poses = _poses(16, 1)
    pts = RNG.uniform(-0.1, 0.1, (16, 30, 3)).astype(np.float32)
    r, t = poses[..., :3], poses[..., 3]
    _close(se3_t._mm(torch.from_numpy(r), torch.from_numpy(r)),
           se3_j._mm(jnp.asarray(r), jnp.asarray(r)))
    _close(se3_t.se3_from_rt(torch.from_numpy(r), torch.from_numpy(t)),
           se3_j.se3_from_rt(jnp.asarray(r), jnp.asarray(t)))
    cam_t = se3_t.transform_points(*map(torch.from_numpy, (pts, r, t)))
    cam_j = se3_j.transform_points(*map(jnp.asarray, (pts, r, t)))
    _close(cam_t, cam_j)
    kb = np.broadcast_to(K, (16, 3, 3)).copy()
    # pixel coordinates: 1e-5 relative to ~500 px
    _close(se3_t.project_points(cam_t, torch.from_numpy(kb)),
           se3_j.project_points(cam_j, jnp.asarray(kb)), atol=5e-3)


def test_apply_and_calc_delta():
    src, tgt = _poses(32, 2), _poses(32, 3)
    kb = np.broadcast_to(K, (32, 3, 3)).copy()
    d_t = dp_t.calc_delta(*map(torch.from_numpy, (src, tgt, kb)))
    d_j = dp_j.calc_delta(*map(jnp.asarray, (src, tgt, kb)))
    _close(d_t.quat, d_j.quat)
    # vx, vy are pixels (~hundreds): 1e-5 relative
    np.testing.assert_allclose(d_t.trans.numpy(), np.asarray(d_j.trans),
                               rtol=1e-5, atol=1e-4)
    delta = (RNG.randn(32, 4).astype(np.float32),
             (RNG.randn(32, 3) * [20.0, 20.0, 0.1]).astype(np.float32))
    out_t = dp_t.apply_delta(torch.from_numpy(src),
                             dp_t.DeltaPose(*map(torch.from_numpy, delta)),
                             torch.from_numpy(kb))
    out_j = dp_j.apply_delta(jnp.asarray(src), dp_j.DeltaPose(*map(jnp.asarray, delta)),
                             jnp.asarray(kb))
    _close(out_t, out_j)


def test_delta_inverse_pair():
    src, tgt = map(torch.from_numpy, (_poses(32, 4), _poses(32, 5)))
    k = torch.from_numpy(np.broadcast_to(K, (32, 3, 3)).copy())
    back = dp_t.apply_delta(src, dp_t.calc_delta(src, tgt, k), k)
    np.testing.assert_allclose(back.numpy(), tgt.numpy(), rtol=0, atol=2e-5)
