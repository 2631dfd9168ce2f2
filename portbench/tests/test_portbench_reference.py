"""The plain reference against the program at small sizes on the CPU.

The reference re-derives what the program makes from a seed (assets,
draws, renders, zoom) and computes the network, the losses and the
optimizer in float32; here each piece is held to the program's own
float32 path on the same inputs, so a fault in the reference shows
before it can judge a run.
"""

import math

import pytest
import torch

from conftest import TINY_EXPERIMENT
from deepim_tpu_torch.cli.train import load_assets_and_names
from deepim_tpu_torch.config import config_from_dict
from deepim_tpu_torch.data.synthetic import synthetic_batch
from deepim_tpu_torch.geometry.delta_pose import DeltaPose
from deepim_tpu_torch.losses import losses as losses_p
from deepim_tpu_torch.ops.flow_gt import calc_flow
from deepim_tpu_torch.ops.zoom import compute_zoom_box, zoom_image_batch, zoom_intrinsics
from deepim_tpu_torch.refine import gather_class, refine_poses, render_crops
from deepim_tpu_torch.train.train import init_state, make_model, make_synthetic_train_step
from portbench import common, flops, roofline
from portbench import weights as weights_mod
from portbench.reference import losses, network, render, zoom
from portbench.reference import refine as ref
from portbench.reference.assets import object_set
from portbench.reference.geometry import draw_batch

SIZE = (60, 80)
OUT = (48, 64)
NOISE = {"rot_deg": 15.0, "rot_max_deg": 45.0, "trans": [0.01, 0.01, 0.05],
         "trans_max": [0.03, 0.03, 0.15]}


def cfg(name="synthetic_all", **sections):
    exp = {"experiment": name, "dataset": dict(TINY_EXPERIMENT["dataset"]),
           "network": dict(TINY_EXPERIMENT["network"]),
           "train": {"batch_size": 4, "optimizer": "adam", "lr": 3e-4, "weight_decay": 0.0,
                     "warmup_steps": 2, "train_iter": 2, "w_flow": 0.05, "w_mask": 0.05},
           "test": {"test_iter": 4, "coarse_iters": 2}}
    for k, v in sections.items():
        exp[k].update(v)
    return config_from_dict(exp)


@pytest.fixture(scope="module")
def world():
    c = cfg()
    assets, names, _ = load_assets_and_names(c, device="cpu")
    objs = object_set(names, c.dataset.num_points, "cpu")
    return c, assets, objs, common.camera(c, "cpu")


def test_assets(world):
    c, assets, objs, _ = world
    f_max = assets.tri_pos.shape[2]
    for i in range(assets.num_classes):
        f = objs.tri_pos[i].shape[1]
        for mine, theirs in ((objs.tri_pos, assets.tri_pos), (objs.tri_col, assets.tri_col),
                             (objs.tri_nrm, assets.tri_nrm)):
            assert torch.equal(mine[i], theirs[i][:, :f])
        # The program pads with faces of zero area, which draw nothing.
        pad = assets.tri_pos[i][:, f:].reshape(3, 3, f_max - f)
        assert torch.equal(pad[0], pad[1]) and torch.equal(pad[1], pad[2])
    assert torch.equal(objs.points, assets.points)
    assert torch.equal(objs.corners, assets.corners)
    assert torch.equal(objs.cull, assets.cull_dir)
    assert torch.equal(objs.sym_poses, assets.sym_poses)
    assert torch.equal(objs.continuous, assets.sym_continuous)
    assert torch.allclose(objs.diameters, assets.diameters)


def test_draws_equal_the_synthetic_generator(world):
    c, assets, objs, k = world
    got = synthetic_batch(torch.Generator().manual_seed(11), assets, 6, k, SIZE)
    g = torch.Generator().manual_seed(11)
    want = draw_batch(g, 4, 6, k, SIZE, NOISE)
    for key in ("class_idx", "pose_tgt", "pose_src"):
        assert torch.equal(got[key], want[key])


def test_render_equals_the_programs_renderer(world):
    c, assets, objs, k = world
    g = torch.Generator().manual_seed(5)
    d = draw_batch(g, 4, 8, k, SIZE, NOISE)
    ks = k.expand(8, 3, 3)
    for size, pose in ((SIZE, d["pose_tgt"]), (OUT, d["pose_src"])):
        kk = ks
        if size == OUT:
            box = compute_zoom_box(pose, ks, assets.corners[d["class_idx"]], OUT)
            kk = zoom_intrinsics(ks, box)
        rgb_p, depth_p = render_crops(gather_class(assets, d["class_idx"]), pose, kk, size)
        rgb_r, depth_r = render.render(objs, d["class_idx"], pose, kk, size)
        assert (depth_r > 0).sum() > 200
        off = ((depth_p > 0) != (depth_r > 0)).float().mean()
        assert off < 2e-3  # a pixel centre on an edge may round to either side
        both = (depth_p > 0) & (depth_r > 0)
        assert torch.allclose(depth_p[both], depth_r[both], rtol=1e-5, atol=1e-6)
        assert torch.allclose(rgb_p[both], rgb_r[both], atol=1e-4)


def test_zoom(world):
    c, assets, objs, k = world
    d = draw_batch(torch.Generator().manual_seed(3), 4, 8, k, SIZE, NOISE)
    ks = k.expand(8, 3, 3)
    corners = assets.corners[d["class_idx"]]
    bp = compute_zoom_box(d["pose_src"], ks, corners, OUT)
    br = zoom.zoom_box(d["pose_src"], ks, objs.corners[d["class_idx"]], OUT)
    for a, b in zip(bp, br):
        assert torch.allclose(a, b, rtol=1e-6)
    assert torch.allclose(zoom_intrinsics(ks, bp), zoom.crop_k(ks, br), rtol=1e-6)
    img = torch.rand((8, *SIZE, 3), generator=torch.Generator().manual_seed(1))
    assert torch.allclose(zoom_image_batch(img, bp, OUT), zoom.crop(img, br, OUT), atol=1e-6)
    assert torch.equal(zoom_image_batch(img, bp, OUT, "nearest"), zoom.crop(img, br, OUT, True))


@pytest.mark.parametrize("decoder", [False, True])
def test_program_rule_equals_the_programs_own_initialisation(decoder):
    """The reference's copy of the program's initial weights, from the same
    seed, is the program's bit for bit (the training cell starts there)."""
    c = cfg()
    model = make_model(c, 4, inference=not decoder, generator=torch.Generator().manual_seed(11))
    shapes = network.param_shapes(4, OUT, decoder, decoder, c.network.fc_dim)
    want = weights_mod.program_rule(shapes, 11)
    got = model.state_dict()
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("decoder", [False, True])
def test_network_equals_the_programs_float32_network(decoder):
    c = cfg()
    model = make_model(c, 4, inference=not decoder)
    shapes = network.param_shapes(4, OUT, decoder, decoder, c.network.fc_dim)
    w = weights_mod.draw(shapes, 9, "cpu", 0.02)
    model.load_state_dict(w)
    x = torch.rand((2, *OUT, 6), generator=torch.Generator().manual_seed(2)) - 0.5
    for size in (OUT, (24, 32)):
        xs = x[:, :size[0], :size[1]].contiguous()
        got = model(xs, pose_only=not decoder)
        want = network.forward(w, xs, network.grid(*OUT), pose_only=not decoder, decoder=decoder,
                               mask=decoder)
        for key in ("rot_raw", "trans"):
            assert torch.allclose(got[key], want[key], rtol=1e-4, atol=1e-5)
        if decoder and size == OUT:
            for lvl in got["flow"]:
                assert torch.allclose(got["flow"][lvl], want["flow"][lvl], rtol=1e-4, atol=1e-5)
            assert torch.allclose(got["mask_logit"], want["mask_logit"], rtol=1e-4, atol=1e-5)


def test_losses_equal_the_programs(world):
    c, assets, objs, k = world
    g = torch.Generator().manual_seed(4)
    d = draw_batch(g, 4, 6, k, SIZE, NOISE)
    cls, src, tgt = d["class_idx"], d["pose_src"], d["pose_tgt"]
    ks = k.expand(6, 3, 3)
    quat = torch.nn.functional.normalize(torch.randn((6, 4), generator=g), dim=-1)
    trans = torch.randn((6, 3), generator=g) * torch.tensor([5.0, 5.0, 0.05])
    ab = gather_class(assets, cls)
    for sym in (False, True):
        got = losses_p.point_matching_loss(ab.points, DeltaPose(quat, trans), src, tgt, ks,
                                           ab.sym_poses if sym else None,
                                           ab.sym_continuous if sym else None)
        want = losses.point_matching(objs.points[cls], quat, trans, src, tgt, ks,
                                     objs.sym_poses[cls] if sym else None,
                                     objs.continuous[cls] if sym else None)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-7)
    box = zoom.zoom_box(src, ks, objs.corners[cls], OUT)
    kz = zoom.crop_k(ks, box)
    _, depth_src = render.render(objs, cls, src, kz, OUT)
    _, depth_obs = render.render(objs, cls, tgt, kz, OUT)
    fg, vg = calc_flow(depth_src, src, tgt, kz, depth_obs, occlusion_stride=4)
    fr, vr = losses.flow_gt(depth_src, src, tgt, kz, depth_obs)
    assert torch.equal(vg, vr) and torch.allclose(fg, fr, atol=1e-4)
    preds = {lvl: torch.randn((6, OUT[0] // 2 ** lvl or 1, OUT[1] // 2 ** lvl or 1, 2),
                              generator=g) for lvl in (6, 5, 4, 3, 2)}
    assert torch.allclose(losses_p.flow_epe_loss(preds, fg, vg), losses.flow_epe(preds, fr, vr),
                          rtol=1e-5)
    logit = torch.randn((6, OUT[0] // 4, OUT[1] // 4, 1), generator=g)
    assert torch.allclose(losses_p.mask_ce_loss(logit, depth_obs > 0),
                          losses.mask_ce(logit, depth_obs > 0), rtol=1e-6)


def test_refine_equals_the_programs_float32_refine(world):
    c, assets, objs, k = world
    c = cfg("synthetic_all_c2f")
    model = make_model(c, 4, inference=True)
    w = weights_mod.draw(network.param_shapes(4, OUT, False, False, c.network.fc_dim), 21,
                         "cpu", 0.02)
    model.load_state_dict(w)
    batch = synthetic_batch(torch.Generator().manual_seed(8), assets, 4, k, SIZE)
    got = refine_poses(model, assets, batch["obs_rgb"], batch["pose_src"], batch["k"],
                       batch["class_idx"], num_iters=4, out_size=OUT, coarse_iters=2)
    rows = ref.synthetic_rows(objs, 8, "cpu", 4, k, SIZE, NOISE)
    assert torch.equal(rows["pose_src"], batch["pose_src"])
    assert ((rows["obs_rgb"] - batch["obs_rgb"]).abs().amax(-1) > 1e-4).float().mean() < 2e-3
    want = ref.refine(w, objs, rows["obs_rgb"], rows["pose_src"], rows["k"], rows["class_idx"],
                      4, 2, OUT, network.grid(*OUT))
    from portbench.compare import pose_gaps

    gaps = pose_gaps(objs.points[rows["class_idx"]], objs.diameters[rows["class_idx"]], got, want)
    assert float(gaps.max()) < 1e-3
    assert float((got - rows["pose_src"]).abs().max()) > 1e-3  # the poses moved


def test_train_steps_equal_the_programs_float32_step(world):
    _, assets, objs, k = world
    c = cfg()
    model = make_model(c, 4)
    w = weights_mod.draw(network.param_shapes(4, OUT, True, True, c.network.fc_dim), 31, "cpu",
                         0.02)
    model.load_state_dict(w)
    state = init_state(c, model)
    step = make_synthetic_train_step(model, assets, c, k)
    losses_p_, grads = [], None
    for i in range(3):
        _, m = step(state, torch.Generator().manual_seed(100 + i))
        losses_p_.append(float(m["loss"]))
        if i == 0:
            grads = {n: state.optimizer.state[p]["exp_avg"] / 0.1
                     for n, p in model.named_parameters()}
    t = c.train
    train = {"train_iter": t.train_iter, "w_pm": t.w_pm, "w_flow": t.w_flow, "w_mask": t.w_mask,
             "flow_occ_stride": t.flow_occ_stride, "grad_clip": t.grad_clip, "lr": t.lr,
             "warmup_steps": t.warmup_steps, "lr_decay_steps": list(t.lr_decay_steps),
             "lr_decay_factor": t.lr_decay_factor, "sym_aware_pm": t.sym_aware_pm}
    batches = [ref.synthetic_rows(objs, 100 + i, "cpu", 4, k, SIZE, NOISE) for i in range(3)]
    params = {n: v.clone() for n, v in w.items()}
    got = ref.train_steps(params, objs, batches, train, OUT, network.grid(*OUT), row_block=3)
    for a, b in zip(losses_p_, got["loss"]):
        assert math.isclose(a, b, rel_tol=2e-3)
    med = torch.tensor([float(g.norm()) for g in got["grad"].values()]).median()
    for n, g in got["grad"].items():
        assert float((grads[n] - g).norm()) <= 2e-2 * max(float(g.norm()), float(med)), n
    for n, p in model.named_parameters():
        moved = float((params[n] - w[n]).norm())
        assert abs(float((p.detach() - w[n]).norm()) - moved) <= 5e-2 * max(moved, 1e-12) + 1e-9, n


def test_flops_of_the_flagship():
    fwd, _ = flops.network_flops((480, 640), (8, 10), False, False, 4)
    coarse, _ = flops.network_flops((240, 320), (8, 10), False, False, 4)
    _, train = flops.network_flops((480, 640), (8, 10), True, True, 4)
    assert round(fwd / 1e9, 2) == 38.04 and round(coarse / 1e9, 2) == 9.68
    assert round(train / 1e9, 2) == 159.25
    assert round(flops.refine_flops((480, 640), (240, 320), 4, 2, (8, 10), 4) / 1e9, 2) == 95.45


def test_render_bound_counts_what_the_render_needs(world):
    c, assets, objs, k = world
    d = draw_batch(torch.Generator().manual_seed(6), 4, 4, k, SIZE, NOISE)
    ks = k.expand(4, 3, 3)
    nbytes, ops = roofline.render_work(objs, d["class_idx"], d["pose_tgt"], ks, SIZE)
    assert nbytes >= 16 * 4 * SIZE[0] * SIZE[1] and ops > 0
    far = d["pose_tgt"].clone()
    far[:, 2, 3] = -1.0  # behind the camera: nothing reaches the image
    assert roofline.render_work(objs, d["class_idx"], far, ks, SIZE) == (16 * 4 * 60 * 80, 0.0)
