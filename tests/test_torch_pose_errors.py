"""deepim_tpu_torch.geometry.pose_errors against deepim_tpu's (CPU).

The same numpy points and poses (made from a seed) go through both
packages; every metric agrees within float32 rounding (rtol 1e-5, atol
1e-6 m, 1e-4 deg / px), ADD-S also with its point blocking and at
‖t‖ ≈ 1 m, where the uncentred ‖a‖²+‖b‖²−2ab form would cancel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.geometry import pose_errors as pe_j
from deepim_tpu_torch.geometry import pose_errors as pe_t

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]], np.float32)


def _rot(rng):
    q = rng.randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _case(seed, batch=5, n=300, tz=0.8, noise=0.01):
    """(points (n, 3), estimated poses (batch, 3, 4), GT poses) near ``tz``."""
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * 0.05).astype(np.float32)
    gt, est = [], []
    for _ in range(batch):
        r = _rot(rng)
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), tz])
        gt.append(np.concatenate([r, t[:, None]], 1))
        dr = _rot(rng) if noise > 0.05 else np.eye(3)
        est.append(np.concatenate([dr @ r, (t + noise * rng.randn(3))[:, None]], 1))
    return pts, np.asarray(est, np.float32), np.asarray(gt, np.float32)


def _both(fn, *args, **kwargs):
    got = getattr(pe_t, fn)(*(torch.from_numpy(a) for a in args), **kwargs).numpy()
    ref = np.asarray(getattr(pe_j, fn)(*(jnp.asarray(a) for a in args), **kwargs))
    assert got.shape == ref.shape
    return got, ref


@pytest.mark.parametrize("seed,noise", [(0, 0.01), (1, 0.2)])
def test_add_rot_trans_proj2d_match(seed, noise):
    pts, est, gt = _case(seed, noise=noise)
    for fn in ("add_error", "proj2d_error"):
        extra = (np.broadcast_to(K, (5, 3, 3)).copy(),) if fn == "proj2d_error" else ()
        got, ref = _both(fn, pts, est, gt, *extra)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4 if extra else 1e-6)
    got, ref = _both("rot_error_deg", est, gt)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    got, ref = _both("trans_error", est, gt)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert (got > 0).all()


@pytest.mark.parametrize("tz,block", [(0.8, None), (0.8, 64), (1.0, 128), (1.0, None)])
def test_adds_matches_with_blocking_at_one_metre(tz, block):
    pts, est, gt = _case(2, n=500, tz=tz, noise=0.002)
    got, ref = _both("adds_error", pts, est, gt, point_block=block)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # Centred, the mm-scale distances survive at ‖t‖ ≈ 1 m: equal to the
    # direct float64 nearest-point distance.
    a = np.einsum("bij,nj->bni", est[:, :, :3].astype(np.float64), pts) + est[:, None, :, 3]
    b = np.einsum("bij,nj->bni", gt[:, :, :3].astype(np.float64), pts) + gt[:, None, :, 3]
    exact = np.sqrt(((b[:, :, None] - a[:, None]) ** 2).sum(-1)).min(-1).mean(-1)
    np.testing.assert_allclose(got, exact, rtol=1e-3, atol=2e-6)
    full = pe_t.adds_error(*(torch.from_numpy(x) for x in (pts, est, gt)))
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-6, atol=1e-7)


def test_add_auc_matches():
    rng = np.random.RandomState(3)
    errors = np.abs(rng.randn(4, 200) * 0.04).astype(np.float32)
    for max_t, steps in ((0.1, 1000), (0.05, 100)):
        got = pe_t.add_auc(torch.from_numpy(errors), max_t, steps).numpy()
        ref = np.asarray(pe_j.add_auc(jnp.asarray(errors), max_t, steps))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        assert ((0 < got) & (got < 1)).all()
