"""deepim_tpu_torch.refine.hypotheses against deepim_tpu's (CPU).

The same numpy inputs go through both packages; the reference renders
with its Pallas kernels in interpret mode, the port with their plain
versions.  ``score_poses`` agrees to atol 1e-4 (score units: mean
truncated |RGB diff|, 0.25 at most), with and without observed depth and
with a common zoom box.  The selection is held against the reference on
the reference's own draw of hypotheses (the two packages' random streams
differ): the same key's hypotheses, recomputed with the reference's
``perturb_poses``, go through the port's ``select_hypotheses``; best
poses and all scores agree to atol 1e-3 (the trajectory tolerance of
tests/test_torch_refine.py) and the same hypotheses win.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.data.pairs import perturb_poses as perturb_j
from deepim_tpu.models import flownet as fn_j
from deepim_tpu.ops.zoom import ZoomBox as ZoomBoxJ
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.refine import hypotheses as hyp_j
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu_torch.models import flownet as fn_t
from deepim_tpu_torch.models.bridge import flax_to_torch
from deepim_tpu_torch.ops.zoom import ZoomBox
from deepim_tpu_torch.refine import hypotheses as hyp_t
from deepim_tpu_torch.refine import refiner as ref_t

H, W = 48, 96
FRAME = (96, 160)
K = np.array([[150.0, 0, 80], [0, 150.0, 48], [0, 0, 1]], np.float32)
INTERP = "pallas_interpret"


def _meshes():
    return [mesh_j.box_mesh((0.08, 0.1, 0.06)), mesh_j.icosphere_mesh(0.05)]


@pytest.fixture(scope="module")
def assets():
    return (ref_t.build_assets(_meshes(), num_points=64, device="cpu"),
            ref_j.build_assets(_meshes(), num_points=64))


def _pose(rx, tz=0.7, tx=0.0):
    c, s = np.cos(rx), np.sin(rx)
    r = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    return np.concatenate([r, [[tx], [0.0], [tz]]], 1).astype(np.float32)


def _scene(assets, b=4):
    """GT poses, their observed frames and depths (rendered by the port),
    classes and intrinsics, with a noisy background."""
    at, _ = assets
    gt = np.stack([_pose(0.3 + 0.2 * i, tx=0.01 * i) for i in range(b)])
    cls = (np.arange(b) % 2).astype(np.int32)
    ks = np.tile(K[None], (b, 1, 1))
    rgb, depth = ref_t.render_crops(ref_t.gather_class(at, torch.from_numpy(cls)),
                                    torch.from_numpy(gt), torch.from_numpy(ks), FRAME)
    rng = np.random.RandomState(0)
    obs = np.where(depth.numpy()[..., None] > 0, rgb.numpy(), rng.rand(b, *FRAME, 3))
    return gt, obs.astype(np.float32), depth.numpy(), cls, ks


def _score_both(assets, obs, poses, ks, cls, depth=None, box=None):
    at, aj = assets
    got = hyp_t.score_poses(
        ref_t.gather_class(at, torch.from_numpy(cls)), torch.from_numpy(obs),
        torch.from_numpy(poses), torch.from_numpy(ks), (H, W),
        obs_depth=None if depth is None else torch.from_numpy(depth),
        box=None if box is None else ZoomBox(*map(torch.from_numpy, box))).numpy()
    ref = np.asarray(hyp_j.score_poses(
        ref_j.gather_class(aj, jnp.asarray(cls)), jnp.asarray(obs), jnp.asarray(poses),
        jnp.asarray(ks), (H, W), INTERP,
        obs_depth=None if depth is None else jnp.asarray(depth),
        box=None if box is None else ZoomBoxJ(*map(jnp.asarray, box))))
    return got, ref


@pytest.mark.parametrize("with_depth,common_box", [
    (False, False), (True, False), (False, True), (True, True)])
def test_score_poses_matches(assets, with_depth, common_box):
    gt, obs, depth, cls, ks = _scene(assets)
    far = gt.copy()
    far[:, :, 3] += np.array([0.03, -0.01, 0.1], np.float32)
    far[3, 2, 3] = -0.5  # behind the camera: renders nothing
    box = None
    if common_box:  # the GT's windows, shared by both pose sets
        x0 = np.array([10.0, 20.0, 15.0, 30.0], np.float32)
        box = (x0, x0 * 0.5, np.full(4, 1.1, np.float32), np.full(4, 1.1, np.float32))
    d = depth if with_depth else None
    s_gt, r_gt = _score_both(assets, obs, gt, ks, cls, d, box)
    s_far, r_far = _score_both(assets, obs, far, ks, cls, d, box)
    np.testing.assert_allclose(s_gt, r_gt, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s_far[:3], r_far[:3], rtol=0, atol=1e-4)
    assert s_far[3] == r_far[3] == -np.inf  # an empty render
    assert np.isfinite(s_gt).all() and (s_gt[:3] > s_far[:3]).all()


def _weights(size=(H, W), seed=0, scale=0.02):
    """Both packages' two-class networks on the same flax weights, pose
    heads randomised -> (flax module, variables, torch module)."""
    grid = fn_j.bottleneck_grid(*size)
    mj = fn_j.DeepIMFlowNet(num_classes=2, dtype=jnp.float32, with_flow=False,
                            with_mask=False, head_grid=grid)
    var = mj.init(jax.random.PRNGKey(seed), jnp.zeros((1, *size, 6)))
    params = jax.tree.map(np.asarray, var["params"])
    rng = np.random.RandomState(seed)
    for head in ("fc_rot", "fc_trans"):
        params[head] = {k: (v + scale * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in params[head].items()}
    mt = fn_t.DeepIMFlowNet(num_classes=2, head_grid=grid, dtype=torch.float32)
    mt.load_state_dict(flax_to_torch(params))
    return mj, {"params": params}, mt


def _reference_draw(key, init, nh, rot_deg=20.0, trans=(0.02, 0.02, 0.08)):
    """The hypotheses the reference's refine_multi_hypothesis draws."""
    b = init.shape[0]
    reps = jnp.tile(jnp.asarray(init), (nh, 1, 1))
    noise = perturb_j(key, reps, rot_std_deg=rot_deg, rot_max_deg=3 * rot_deg,
                      trans_std=trans, trans_max=tuple(3 * t for t in trans))
    return np.array(jnp.where((jnp.arange(nh * b) < b)[:, None, None], reps, noise))


@pytest.mark.parametrize("margin,with_depth", [(0.0, False), (0.05, True)])
def test_selection_matches_reference_on_its_draw(assets, margin, with_depth):
    at, aj = assets
    gt, obs, depth, cls, ks = _scene(assets)
    init = gt.copy()
    init[:, :, 3] += np.array([0.01, -0.005, 0.03], np.float32)
    mj, var, mt = _weights()
    key, nh = jax.random.PRNGKey(5), 3
    d = depth if with_depth else None
    best_j, sc_j = hyp_j.refine_multi_hypothesis(
        var, mj, aj, jnp.asarray(obs), jnp.asarray(init), jnp.asarray(ks), jnp.asarray(cls),
        key, num_hypotheses=nh, num_iters=2, out_size=(H, W), renderer=INTERP,
        select_margin=margin, obs_depth=None if d is None else jnp.asarray(d))
    hyps = _reference_draw(key, init, nh)
    best_t, sc_t = hyp_t.select_hypotheses(
        mt, at, torch.from_numpy(obs), torch.from_numpy(hyps), torch.from_numpy(ks),
        torch.from_numpy(cls), num_iters=2, out_size=(H, W), select_margin=margin,
        obs_depth=None if d is None else torch.from_numpy(d))
    best_j, sc_j = np.asarray(best_j), np.asarray(sc_j)
    assert best_t.shape == (4, 3, 4) and sc_t.shape == (4, nh)
    np.testing.assert_allclose(sc_t.numpy(), sc_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(best_t.numpy(), best_j, rtol=0, atol=1e-3)
    assert np.abs(best_j - init).max() > 1e-2  # the randomised heads move the poses

    def winners(sc):
        return np.where(sc.max(1) - sc[:, 0] > margin, sc.argmax(1), 0)

    assert (winners(sc_t.numpy()) == winners(sc_j)).all()


def test_multi_hypothesis_draw_keeps_hypothesis_zero(assets):
    init = np.stack([_pose(0.3), _pose(0.5, tx=0.02)])
    g = torch.Generator().manual_seed(0)
    hyps = hyp_t.draw_hypotheses(g, torch.from_numpy(init), 4)
    assert hyps.shape == (8, 3, 4)
    assert torch.equal(hyps[:2], torch.from_numpy(init))
    moved = (hyps[2:] - torch.from_numpy(init).repeat(3, 1, 1)).abs().amax((1, 2))
    assert (moved > 1e-3).all()
    rot = hyps[:, :, :3]
    eye = torch.eye(3).expand(8, 3, 3)
    torch.testing.assert_close(rot @ rot.transpose(1, 2), eye, atol=1e-5, rtol=0)


def test_multi_hypothesis_select_margin(assets):
    """The margin cases of tests/test_refiner.py on the port: hypothesis 0
    is kept unless a challenger clears the margin, but a diverged
    hypothesis 0 (-inf) is always replaced by a finite challenger."""
    at, _ = assets
    cls = torch.tensor([0, 1])
    k = torch.from_numpy(np.tile(K[None], (2, 1, 1)))
    gt = torch.from_numpy(np.stack([_pose(0.3), _pose(-0.2, tx=0.05)]))
    obs, _ = ref_t.render_crops(ref_t.gather_class(at, cls), gt, k, FRAME)
    model = fn_t.DeepIMFlowNet(num_classes=2, input_size=(H, W), dtype=torch.float32)

    def run(init, margin, nh=4):
        return hyp_t.refine_multi_hypothesis(
            model, at, obs, init, k, cls, torch.Generator().manual_seed(3),
            num_hypotheses=nh, num_iters=1, out_size=(H, W), select_margin=margin)

    best_inf, _ = run(gt, float("inf"))  # always hypothesis 0
    torch.testing.assert_close(best_inf, gt, atol=1e-4, rtol=0)
    best, scores = run(gt, 0.05, nh=3)  # identity net: the exact GT init wins
    assert best.shape == (2, 3, 4) and scores.shape == (2, 3)
    torch.testing.assert_close(best, gt, atol=1e-4, rtol=0)

    behind = gt.clone()
    behind[:, 2, 3] = -0.5
    best_resc, scores = run(behind, 0.05)
    assert scores[:, 0].max() == -np.inf
    finite_any = torch.isfinite(scores[:, 1:]).any(1)
    changed = (best_resc - behind).abs().amax((1, 2)) > 1e-6
    assert torch.equal(changed, finite_any) and finite_any.any()
