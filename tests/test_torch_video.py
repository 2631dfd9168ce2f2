"""deepim_tpu_torch.refine.video against deepim_tpu's (CPU).

Both packages track the same numpy frames with the same flax weights
(pose heads randomised so poses move); the reference renders with its
Pallas kernels in interpret mode.  Trajectories agree to atol 1e-3, the
trajectory tolerance of tests/test_torch_refine.py, in plain propagation
in armed recovery with one hypothesis (the incumbent alone, so no
random draw is involved), and in one re-acquisition among three
candidates, the reference's re-seeds fed to the port; recovery scores to
atol 1e-3 too.  The recovery properties of tests/test_scene_video.py hold
on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.data.pairs import perturb_poses as perturb_j
from deepim_tpu.raster import mesh as mesh_j
from deepim_tpu.refine import refiner as ref_j
from deepim_tpu.refine import video as video_j
from deepim_tpu_torch.models import flownet as fn_t
from deepim_tpu_torch.refine import hypotheses as hyp_t
from deepim_tpu_torch.refine import refiner as ref_t
from deepim_tpu_torch.refine import video as video_t
from test_torch_hypotheses import _weights as hypotheses_weights

H, W = 64, 128
K = np.array([[120.0, 0, 64], [0, 120.0, 32], [0, 0, 1]], np.float32)
INTERP = "pallas_interpret"
T = 3


def _meshes():
    return [mesh_j.box_mesh((0.3, 0.3, 0.06)), mesh_j.icosphere_mesh(0.05)]


@pytest.fixture(scope="module")
def assets():
    return (ref_t.build_assets(_meshes(), num_points=64, device="cpu"),
            ref_j.build_assets(_meshes(), num_points=64))


def _pose(tz=0.7, tx=0.0, ty=0.0, rx=0.0):
    c, s = np.cos(rx), np.sin(rx)
    r = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    return np.concatenate([r, [[tx], [ty], [tz]]], 1).astype(np.float32)


def _weights():
    return hypotheses_weights((H, W))


def _stream(assets, b=2, shared=True):
    """Frames of a sphere drifting in x over the box (T, H, W, 3) shared, or
    (T, B, H, W, 3) per object, their depths, and the frame-0 GT."""
    at, _ = assets
    cls = np.array([1, 0, 1, 0][:b], np.int32)
    ks = np.tile(K[None], (b, 1, 1))
    gts = [np.stack([_pose(0.6 + 0.05 * i, tx=0.004 * t, rx=0.2 * i) for i in range(b)])
           for t in range(T)]
    frames, depths = [], []
    for gt in gts:
        rgb, depth = ref_t.render_crops(ref_t.gather_class(at, torch.from_numpy(cls)),
                                        torch.from_numpy(gt), torch.from_numpy(ks), (H, W))
        frames.append(rgb.numpy()[0] if shared else rgb.numpy())
        depths.append(depth.numpy()[0] if shared else depth.numpy())
    init = gts[0].copy()
    init[:, :, 3] += np.array([0.006, -0.004, 0.02], np.float32)
    return np.stack(frames), np.stack(depths), init, ks, cls


def _track_both(assets, frames, init, ks, cls, **kwargs):
    at, aj = assets
    mj, var, mt = _weights()
    jargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    targs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in kwargs.items()}
    ref = video_j.refine_video(var, mj, aj, jnp.asarray(frames), jnp.asarray(init),
                               jnp.asarray(ks), jnp.asarray(cls), iters_first=2, iters_rest=1,
                               out_size=(H, W), renderer=INTERP, **jargs)
    got = video_t.refine_video(mt, at, torch.from_numpy(frames), torch.from_numpy(init),
                               torch.from_numpy(ks), torch.from_numpy(cls), iters_first=2,
                               iters_rest=1, out_size=(H, W), **targs)
    return got, ref


@pytest.mark.parametrize("shared", [True, False])
def test_plain_propagation_matches_reference(assets, shared):
    frames, _, init, ks, cls = _stream(assets, shared=shared)
    got, ref = _track_both(assets, frames, init, ks, cls)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (T, 2, 3, 4)
    assert np.abs(ref[-1] - init).max() > 1e-2  # the randomised heads move the poses
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


def test_recovery_matches_reference_with_one_hypothesis(assets):
    # One hypothesis is the incumbent alone: re-acquisition refines it
    # recover_iters more times and scores it in its old zoom window.  A
    # threshold of 0 (scores are <= 0) arms it on every frame, and a margin
    # of -1 (scores lie in [-0.25, 0]) makes every frame take it.
    frames, depths, init, ks, cls = _stream(assets)
    (traj_t, sc_t), (traj_j, sc_j) = _track_both(
        assets, frames, init, ks, cls, obs_depths=depths, recover_threshold=0.0,
        recover_hypotheses=1, recover_iters=1, recover_margin=-1.0)
    plain = video_t.refine_video(_weights()[2], assets[0], torch.from_numpy(frames),
                                 torch.from_numpy(init), torch.from_numpy(ks),
                                 torch.from_numpy(cls), iters_first=2, iters_rest=1,
                                 out_size=(H, W), obs_depths=torch.from_numpy(depths))
    assert sc_t.shape == (T, 2) and np.isfinite(sc_t.numpy()).all()
    assert (traj_t - plain).abs().max() > 1e-3  # the frames took the re-acquired poses
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), rtol=0, atol=1e-3)
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=0, atol=1e-3)


def test_reacquire_matches_reference_on_its_reseeds(assets):
    # The reference's frame-0 re-acquisition with three hypotheses: its key
    # split and re-seed draw are rebuilt around the port's frame-0 pose and
    # fed to the port's reacquire on the shared (stride-0) frame.  Threshold
    # 0 and margin -1 make frame 0 take the re-acquired pose on both sides.
    at, aj = assets
    mj, var, mt = _weights()
    frames, depths, init, ks, cls = _stream(assets)
    nh, rot_deg, trans = 3, 20.0, (0.04, 0.04, 0.04)
    jkey = jax.random.PRNGKey(10)
    traj_j, sc_j = video_j.refine_video(
        var, mj, aj, jnp.asarray(frames[:1]), jnp.asarray(init), jnp.asarray(ks),
        jnp.asarray(cls), iters_first=2, out_size=(H, W), renderer=INTERP,
        obs_depths=jnp.asarray(depths[:1]), recover_threshold=0.0, recover_hypotheses=nh,
        recover_iters=1, recover_rot_deg=rot_deg, recover_trans=trans, recover_margin=-1.0,
        key=jkey)

    frame = torch.from_numpy(frames[0]).expand(2, H, W, 3)
    depth = torch.from_numpy(depths[0]).expand(2, H, W)
    k_t, cls_t = torch.from_numpy(ks), torch.from_numpy(cls)
    pose0 = video_t.refine_video(mt, at, torch.from_numpy(frames[:1]), torch.from_numpy(init),
                                 k_t, cls_t, iters_first=2, out_size=(H, W),
                                 obs_depths=torch.from_numpy(depths[:1]))[0]
    _, k0 = jax.random.split(jkey)
    pert = perturb_j(k0, jnp.tile(jnp.asarray(pose0.numpy()), (nh - 1, 1, 1)),
                     rot_std_deg=rot_deg, rot_max_deg=3 * rot_deg, trans_std=trans,
                     trans_max=tuple(3 * t for t in trans))
    cand = torch.cat([pose0, torch.from_numpy(np.array(pert))])
    assert frame.stride(0) == 0 and depth.stride(0) == 0
    pose_r, sc_r = video_t.reacquire(mt, at, cand, frame, k_t, cls_t, (H, W),
                                     depth=depth, iters=1)
    alone, _ = video_t.reacquire(mt, at, pose0, frame, k_t, cls_t, (H, W), depth=depth,
                                 iters=1)
    assert (pose_r - alone).abs().amax((1, 2)).max() > 1e-3  # a re-seed won a track
    np.testing.assert_allclose(pose_r.numpy(), np.asarray(traj_j[0]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(sc_r.numpy(), np.asarray(sc_j[0]), rtol=0, atol=1e-3)


def test_shared_frames_equal_replicated_frames(assets):
    at, _ = assets
    mt = _weights()[2]
    frames, depths, init, ks, cls = _stream(assets)
    runs = []
    for f, d in ((frames, depths),
                 (np.repeat(frames[:, None], 2, 1), np.repeat(depths[:, None], 2, 1))):
        runs.append(video_t.refine_video(
            mt, at, torch.from_numpy(np.ascontiguousarray(f)), torch.from_numpy(init),
            torch.from_numpy(ks), torch.from_numpy(cls), iters_first=2, iters_rest=1,
            out_size=(H, W), obs_depths=torch.from_numpy(np.ascontiguousarray(d)),
            recover_threshold=0.0, recover_hypotheses=3, recover_iters=1,
            generator=torch.Generator().manual_seed(1)))
    (traj_s, sc_s), (traj_r, sc_r) = runs
    torch.testing.assert_close(traj_s, traj_r, rtol=0, atol=1e-6)
    torch.testing.assert_close(sc_s, sc_r, rtol=0, atol=1e-6)


def test_lost_track_recovery(assets):
    """The recovery properties of tests/test_scene_video.py on the port:
    with an identity refiner, armed recovery (a) leaves a healthy track
    bit-identical, (b) only ever improves a broken track's score, and (c)
    pulls it closer to GT on a static scene."""
    at, _ = assets
    model = fn_t.DeepIMFlowNet(num_classes=2, input_size=(H, W), dtype=torch.float32)
    cls = torch.tensor([1])
    gt = torch.from_numpy(_pose(0.7))[None]
    k = torch.from_numpy(K)[None]
    ab = ref_t.gather_class(at, cls)
    frame, fdepth = ref_t.render_crops(ab, gt, k, (H, W))
    frames = frame[0].expand(T, H, W, 3)
    depths = fdepth[0].expand(T, H, W)
    bad = torch.from_numpy(_pose(0.7, tx=0.06, ty=0.03))[None]
    sc_gt = hyp_t.score_poses(ab, frame, gt, k, (H, W), obs_depth=fdepth).item()
    sc_bad = hyp_t.score_poses(ab, frame, bad, k, (H, W), obs_depth=fdepth).item()
    assert sc_bad < sc_gt
    thresh = 0.5 * (sc_gt + sc_bad)
    common = dict(iters_first=1, iters_rest=1, out_size=(H, W), obs_depths=depths)

    plain = video_t.refine_video(model, at, frames, gt, k, cls, **common)
    armed, sc = video_t.refine_video(model, at, frames, gt, k, cls, recover_threshold=thresh,
                                     generator=torch.Generator().manual_seed(3), **common)
    assert armed.shape == (T, 1, 3, 4) and sc.shape == (T, 1)
    assert torch.equal(armed, plain)
    assert (sc >= thresh).all()

    lost = video_t.refine_video(model, at, frames, bad, k, cls, **common)
    torch.testing.assert_close(lost[-1], bad, atol=1e-5, rtol=0)
    rec, sc_rec = video_t.refine_video(
        model, at, frames, bad, k, cls, recover_threshold=thresh, recover_hypotheses=16,
        recover_iters=1, recover_margin=0.0, generator=torch.Generator().manual_seed(4),
        **common)
    assert (sc_rec[1:] >= sc_rec[:-1]).all() and sc_rec[-1, 0].item() > sc_bad
    err_lost = torch.linalg.vector_norm(lost[-1, 0, :, 3] - gt[0, :, 3])
    err_rec = torch.linalg.vector_norm(rec[-1, 0, :, 3] - gt[0, :, 3])
    assert err_rec < err_lost
