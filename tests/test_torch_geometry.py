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


def test_se3_mul_and_inverse():
    a, b = _poses(16, 6), _poses(16, 7)
    ab_t = se3_t.se3_mul(torch.from_numpy(a), torch.from_numpy(b))
    _close(ab_t, se3_j.se3_mul(jnp.asarray(a), jnp.asarray(b)))
    inv_t = se3_t.se3_inverse(torch.from_numpy(a))
    _close(inv_t, se3_j.se3_inverse(jnp.asarray(a)))
    # broadcast over a symmetry axis, as the point-matching loss uses it
    syms = _poses(5, 8)
    _close(se3_t.se3_mul(torch.from_numpy(a)[:, None], torch.from_numpy(syms)),
           se3_j.se3_mul(jnp.asarray(a)[:, None], jnp.asarray(syms)))
    eye = se3_t.se3_mul(torch.from_numpy(a), inv_t)
    _close(eye, np.broadcast_to(np.eye(3, 4, dtype=np.float32), (16, 3, 4)))


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


# -- the public helpers of deepim_tpu.geometry (tests/test_rotations.py) --------

@pytest.mark.parametrize("name", ["quat_mul", "quat_conjugate", "quat2euler", "mat2euler",
                                  "axangle2quat", "axangle2mat"])
def test_rotation_helpers_match_reference(name):
    q2 = RNG.randn(64, 4).astype(np.float32)
    axis = RNG.randn(64, 3).astype(np.float32)
    angle = ANGLES[0]
    args = {"quat_mul": (QUATS, q2), "quat_conjugate": (QUATS,), "quat2euler": (QUATS,),
            "mat2euler": (np.array(rot_j.quat2mat(jnp.asarray(QUATS))),),
            "axangle2quat": (axis, angle), "axangle2mat": (axis, angle)}[name]
    got = getattr(rot_t, name)(*(torch.from_numpy(a) for a in args))
    want = getattr(rot_j, name)(*(jnp.asarray(a) for a in args))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_rotation_helper_identities():
    """tests/test_rotations.py's identities on the port: the Hamilton
    product composes the matrices, q (x) conj(q) is the identity, euler
    and axis-angle round trips, and gimbal lock."""
    q1, q2 = (rot_t.quat_normalize(torch.from_numpy(RNG.randn(16, 4).astype(np.float32)))
              for _ in range(2))
    torch.testing.assert_close(rot_t.quat2mat(rot_t.quat_mul(q1, q2)),
                               rot_t.quat2mat(q1) @ rot_t.quat2mat(q2), atol=1e-5, rtol=0)
    ident = rot_t.quat_mul(q1, rot_t.quat_conjugate(q1))
    torch.testing.assert_close(ident, torch.tensor([1.0, 0, 0, 0]).expand(16, 4),
                               atol=1e-6, rtol=0)
    ax, ay, az = (torch.from_numpy(a) for a in RNG.uniform(-1.4, 1.4, (3, 16)).astype(np.float32))
    for got, want in zip(rot_t.mat2euler(rot_t.euler2mat(ax, ay, az)), (ax, ay, az)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for got, want in zip(rot_t.quat2euler(rot_t.euler2quat(ax, ay, az)), (ax, ay, az)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    m = rot_t.axangle2mat(torch.tensor([0.0, 1.0, 0.0]), torch.tensor(0.7))
    torch.testing.assert_close(rot_t.rotation_angle(m), torch.tensor(0.7), atol=1e-6, rtol=0)
    lock = rot_t.euler2mat(torch.tensor(0.3), torch.tensor(np.pi / 2), torch.tensor(0.0))
    ax2, ay2, az2 = rot_t.mat2euler(lock)
    torch.testing.assert_close(rot_t.euler2mat(ax2, ay2, az2), lock, atol=1e-5, rtol=0)
    assert float(az2) == 0.0


def test_geometry_exports_the_reference_rotation_helpers():
    import deepim_tpu.geometry as geo_j
    import deepim_tpu_torch.geometry as geo_t

    for name in ("quat_mul", "quat_conjugate", "mat2euler", "quat2euler", "axangle2mat",
                 "axangle2quat"):
        assert hasattr(geo_j, name) and callable(getattr(geo_t, name)), name
