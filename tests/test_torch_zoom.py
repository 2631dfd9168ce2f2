"""deepim_tpu_torch.ops (zoom + resample) against deepim_tpu.ops (CPU).

float32 on both sides, atol 1e-5 relative to each output's scale; the
reference's resample runs at Precision.HIGHEST here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.ops import resample as rs_j
from deepim_tpu.ops import zoom as zoom_j
from deepim_tpu.geometry.rotations import quat2mat
from deepim_tpu_torch.ops import resample as rs_t
from deepim_tpu_torch.ops import zoom as zoom_t

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
OUT = (48, 64)


def _setup(n=6, seed=0):
    rng = np.random.RandomState(seed)
    r = np.asarray(quat2mat(jnp.asarray(rng.randn(n, 4).astype(np.float32))))
    t = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.08, 0.08, n),
                  rng.uniform(0.4, 1.5, n)], -1).astype(np.float32)
    poses = np.concatenate([r, t[..., None]], -1)
    lo, hi = rng.uniform(-0.06, -0.02, (n, 3)), rng.uniform(0.02, 0.06, (n, 3))
    corners = np.stack([np.asarray(zoom_j.model_corners(jnp.asarray(a), jnp.asarray(b)))
                        for a, b in zip(lo, hi)]).astype(np.float32)
    return poses, np.broadcast_to(K, (n, 3, 3)).copy(), corners, lo, hi


def _box_j(poses, ks, corners):
    return jax.vmap(lambda p, k, c: zoom_j.compute_zoom_box(p, k, c, OUT))(
        jnp.asarray(poses), jnp.asarray(ks), jnp.asarray(corners))


def _close(t, j, rel=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=rel * max(1.0, np.abs(j).max()))


def test_model_corners():
    _, _, corners, lo, hi = _setup()
    got = torch.stack([zoom_t.model_corners(a, b) for a, b in zip(lo, hi)])
    _close(got, corners)


def test_compute_zoom_box_and_intrinsics():
    poses, ks, corners, _, _ = _setup()
    box_t = zoom_t.compute_zoom_box(*map(torch.from_numpy, (poses, ks, corners)), OUT)
    box_j = _box_j(poses, ks, corners)
    for a, b in zip(box_t, box_j):
        _close(a, b)
    _close(zoom_t.zoom_intrinsics(torch.from_numpy(ks), box_t),
           zoom_j.zoom_intrinsics(jnp.asarray(ks), box_j))


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_resample_affine(method):
    poses, ks, corners, _, _ = _setup(seed=1)
    box_j = _box_j(poses, ks, corners)
    img = np.random.RandomState(2).rand(6, 96, 160, 3).astype(np.float32)
    out_j = jax.vmap(lambda im, x0, y0, sx, sy: rs_j.resample_affine(
        im, OUT, x0, y0, sx, sy, method=method))(jnp.asarray(img), *box_j)
    box_t = [torch.from_numpy(np.array(a)) for a in box_j]
    out_t = rs_t.resample_affine(torch.from_numpy(img), OUT, *box_t, method=method)
    assert out_t.shape == (6, *OUT, 3)
    _close(out_t, out_j)
    batch_t = zoom_t.zoom_image_batch(torch.from_numpy(img), zoom_t.ZoomBox(*box_t),
                                      OUT, method=method)
    assert torch.equal(batch_t, out_t)


@pytest.mark.parametrize("fn", ["_bilinear_matrix", "_nearest_matrix"])
def test_interp_matrices(fn):
    # Sources straddling both image edges and exact half-pixel ties.
    src = np.concatenate([np.linspace(-3.0, 43.0, 97), np.arange(0, 40) + 0.0]
                         ).astype(np.float32)
    _close(getattr(rs_t, fn)(torch.from_numpy(src), 40),
           getattr(rs_j, fn)(jnp.asarray(src), 40))
