"""deepim_tpu_torch.losses against deepim_tpu.losses (float32, CPU).

The same numpy inputs through both packages; each per-sample loss and its
gradient with respect to the prediction (the delta's quaternion and
translation; the flow pyramid; the mask logits) agree to atol 1e-5
(float32 rounding of sums taken in another order).  The point-matching
cases cover the plain loss, the symmetric min over an identity-padded set
(whose ties split the gradient in both) and the closed-form continuous-z
branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.geometry import rotations as rot_j
from deepim_tpu.geometry.delta_pose import DeltaPose as DeltaJ
from deepim_tpu.losses import losses as loss_j
from deepim_tpu_torch.geometry.delta_pose import DeltaPose as DeltaT
from deepim_tpu_torch.geometry.symmetry import rot_z_syms, sym_set
from deepim_tpu_torch.losses import losses as loss_t

ATOL = 1e-5
B, N = 6, 50


def _poses(rng, n):
    r = np.asarray(rot_j.quat2mat(jnp.asarray(rng.randn(n, 4).astype(np.float32))))
    t = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(0.5, 1.2, n)], -1)
    return np.concatenate([r, t[..., None]], -1).astype(np.float32)


def _pm_inputs(seed):
    rng = np.random.RandomState(seed)
    points = rng.uniform(-0.05, 0.05, (B, N, 3)).astype(np.float32)
    quat = (np.array([1.0, 0, 0, 0]) + 0.2 * rng.randn(B, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    trans = (rng.randn(B, 3) * [5.0, 5.0, 0.05]).astype(np.float32)
    k = np.broadcast_to(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]],
                                 np.float32), (B, 3, 3)).copy()
    syms = np.stack([sym_set(s, 8) for s in
                     (None, rot_z_syms(2), rot_z_syms(8), None, rot_z_syms(4), None)])
    cont = np.array([False, False, True, False, True, True])
    return points, quat, trans, _poses(rng, B), _poses(rng, B), k, syms, cont


@pytest.mark.parametrize("case", ["plain", "symmetric", "continuous_z"])
def test_point_matching_loss_and_gradient(case):
    points, quat, trans, src, tgt, k, syms, cont = _pm_inputs(seed=1)
    kw_j, kw_t = {}, {}
    if case != "plain":
        kw_j["sym_poses"], kw_t["sym_poses"] = jnp.asarray(syms), torch.from_numpy(syms)
    if case == "continuous_z":
        kw_j["sym_continuous"] = jnp.asarray(cont)
        kw_t["sym_continuous"] = torch.from_numpy(cont)

    def f_j(q, t):
        return loss_j.point_matching_loss(jnp.asarray(points), DeltaJ(q, t),
                                          jnp.asarray(src), jnp.asarray(tgt),
                                          jnp.asarray(k), **kw_j)

    ref = np.asarray(f_j(jnp.asarray(quat), jnp.asarray(trans)))
    gq_j, gt_j = jax.grad(lambda q, t: jnp.sum(f_j(q, t)), argnums=(0, 1))(
        jnp.asarray(quat), jnp.asarray(trans))
    q_t = torch.from_numpy(quat).requires_grad_()
    t_t = torch.from_numpy(trans).requires_grad_()
    got = loss_t.point_matching_loss(torch.from_numpy(points), DeltaT(q_t, t_t),
                                     torch.from_numpy(src), torch.from_numpy(tgt),
                                     torch.from_numpy(k), **kw_t)
    got.sum().backward()
    assert got.shape == (B,) and ref.min() > 1e-3
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(q_t.grad.numpy(), np.asarray(gq_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_t.grad.numpy(), np.asarray(gt_j), rtol=0, atol=ATOL)
    if case == "continuous_z":
        # The closed-form angle is taken by some sample.
        plain = loss_j.point_matching_loss(jnp.asarray(points), DeltaJ(
            jnp.asarray(quat), jnp.asarray(trans)), jnp.asarray(src), jnp.asarray(tgt),
            jnp.asarray(k), sym_poses=jnp.asarray(syms))
        assert (ref < np.asarray(plain) - 1e-6).any()


def test_optimal_z_angle_and_rz_pose():
    points, quat, trans, src, tgt, k, _, _ = _pm_inputs(seed=2)
    p_est = np.random.RandomState(3).uniform(-0.1, 0.1, (B, N, 3)).astype(np.float32)
    np.testing.assert_allclose(
        loss_t._optimal_z_angle(torch.from_numpy(points), torch.from_numpy(p_est),
                                torch.from_numpy(tgt)).numpy(),
        np.asarray(loss_j._optimal_z_angle(jnp.asarray(points), jnp.asarray(p_est),
                                           jnp.asarray(tgt))), rtol=0, atol=ATOL)
    theta = np.linspace(-3, 3, B).astype(np.float32)
    np.testing.assert_allclose(loss_t._rz_pose(torch.from_numpy(theta)).numpy(),
                               np.asarray(loss_j._rz_pose(jnp.asarray(theta))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(48, 64), (50, 70)])
def test_flow_epe_loss_and_gradient(size):
    rng = np.random.RandomState(4)
    h, w = size
    gt = (rng.randn(3, h, w, 2) * 4).astype(np.float32)
    valid = rng.rand(3, h, w) > 0.4
    valid[2] = False  # a sample with no valid pixel
    preds = {lvl: (rng.randn(3, -(-h // 2 ** lvl), -(-w // 2 ** lvl), 2) * 4
                   ).astype(np.float32) for lvl in (6, 5, 4, 3, 2)}
    # The valid-weighted pooling alone.
    pooled_t = loss_t._downsample_flow(torch.from_numpy(gt), torch.from_numpy(valid).float(), 4)
    pooled_j = loss_j._downsample_flow(jnp.asarray(gt), jnp.asarray(valid, jnp.float32), 4)
    np.testing.assert_allclose(pooled_t[0].numpy(), np.asarray(pooled_j[0]), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pooled_t[1].numpy(), np.asarray(pooled_j[1]))

    def f_j(p):
        return loss_j.flow_epe_loss(p, jnp.asarray(gt), jnp.asarray(valid))

    pj = {k: jnp.asarray(v) for k, v in preds.items()}
    ref = np.asarray(f_j(pj))
    grads_j = jax.grad(lambda p: jnp.sum(f_j(p)))(pj)
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    got = loss_t.flow_epe_loss(pt, torch.from_numpy(gt), torch.from_numpy(valid))
    got.sum().backward()
    assert ref[:2].min() > 0.1 and ref[2] == 0.0
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=ATOL)
    for lvl in preds:
        np.testing.assert_allclose(pt[lvl].grad.numpy(), np.asarray(grads_j[lvl]),
                                   rtol=0, atol=ATOL, err_msg=str(lvl))


@pytest.mark.parametrize("size", [(48, 64), (50, 70)])
def test_mask_ce_loss_and_gradient(size):
    rng = np.random.RandomState(5)
    h, w = size
    logit = (rng.randn(2, -(-h // 4), -(-w // 4), 1) * 3).astype(np.float32)
    gt = rng.rand(2, h, w) > 0.5

    def f_j(x):
        return loss_j.mask_ce_loss(x, jnp.asarray(gt))

    ref = np.asarray(f_j(jnp.asarray(logit)))
    g_j = jax.grad(lambda x: jnp.sum(f_j(x)))(jnp.asarray(logit))
    x_t = torch.from_numpy(logit).requires_grad_()
    got = loss_t.mask_ce_loss(x_t, torch.from_numpy(gt))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(g_j), rtol=0, atol=ATOL)


def test_angle_trans_l1_loss_and_gradient():
    rng = np.random.RandomState(6)
    q, qg = rng.randn(2, B, 4).astype(np.float32)
    qg[:3] *= -1.0  # quaternions up to sign
    t, tg = rng.randn(2, B, 3).astype(np.float32)

    def f_j(a, b):
        return loss_j.angle_trans_l1_loss(DeltaJ(a, b), DeltaJ(jnp.asarray(qg),
                                                               jnp.asarray(tg)))

    rot_j_, trans_j_ = f_j(jnp.asarray(q), jnp.asarray(t))
    gq, gt = jax.grad(lambda a, b: sum(jnp.sum(x) for x in f_j(a, b)), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(t))
    q_t, t_t = torch.from_numpy(q).requires_grad_(), torch.from_numpy(t).requires_grad_()
    rot, trans = loss_t.angle_trans_l1_loss(DeltaT(q_t, t_t), DeltaT(
        torch.from_numpy(qg), torch.from_numpy(tg)))
    (rot.sum() + trans.sum()).backward()
    np.testing.assert_allclose(rot.detach().numpy(), np.asarray(rot_j_), rtol=0, atol=ATOL)
    np.testing.assert_allclose(trans.detach().numpy(), np.asarray(trans_j_), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(q_t.grad.numpy(), np.asarray(gq), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_t.grad.numpy(), np.asarray(gt), rtol=0, atol=ATOL)


def test_one_copy_of_the_flow_level_weights():
    from deepim_tpu_torch.config import config as cfg_t

    assert loss_t.FLOW_LEVEL_WEIGHTS is cfg_t.FLOW_LEVEL_WEIGHTS
    assert loss_t.FLOW_LEVEL_WEIGHTS == loss_j.FLOW_LEVEL_WEIGHTS
