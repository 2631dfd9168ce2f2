"""deepim_tpu_torch.models (DeepIMFlowNet + bridge) vs flax.

Shared random weights go through models/bridge.py; the zero-initialised
pose heads are randomised at a small scale so the outputs carry the whole
network.  float32 on both sides: rot_raw/trans agree to 1e-4 of their
scale (the convolutions sum in another order); the decoder's flow pyramid
and mask logits, and one transposed conv alone, to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.models import flownet as fn_j
from deepim_tpu_torch.models import flownet as fn_t
from deepim_tpu_torch.models.bridge import flax_to_torch, torch_to_flax

C = 3


def randomize_heads(params, seed=0, scale=1.0):
    """Small random fc_rot/fc_trans weights (numpy tree, modified copy)."""
    rng = np.random.RandomState(seed)
    out = {k: dict(v) for k, v in params.items()}
    for head in ("fc_rot", "fc_trans"):
        out[head] = {k: (v + scale * rng.randn(*v.shape)).astype(np.float32)
                     for k, v in params[head].items()}
    return out


def _torch_model(**kwargs):
    """A torch network built with uniform draws inside flax's truncation in
    place of truncated normals, twenty times cheaper: for a model whose
    weights are loaded or do not matter (its initialisation is tested
    below with the real draws)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.init, "trunc_normal_",
                   lambda p, std, a, b, generator: p.uniform_(a, b, generator=generator))
        return fn_t.DeepIMFlowNet(**kwargs)


def _models(input_size, head_grid=None, dtype=torch.float32):
    mj = fn_j.DeepIMFlowNet(num_classes=C, dtype=jnp.float32, with_flow=False,
                            with_mask=False, head_grid=head_grid)
    init_hw = head_grid and (head_grid[0] * 64, head_grid[1] * 64) or input_size
    var = mj.init(jax.random.PRNGKey(0), jnp.zeros((1, *init_hw, 6)))
    params = randomize_heads(jax.tree.map(np.asarray, var["params"]))
    mt = _torch_model(num_classes=C, head_grid=head_grid, input_size=input_size, dtype=dtype)
    mt.load_state_dict(flax_to_torch(params))
    return mj, {"params": params}, mt


def _compare(input_size, head_grid=None, dtype=torch.float32, rel=1e-4, seed=1):
    mj, var, mt = _models(input_size, head_grid, dtype)
    x = np.random.RandomState(seed).uniform(-0.5, 0.5, (2, *input_size, 6)).astype(np.float32)
    out_j = mj.apply(var, jnp.asarray(x), pose_only=True)
    with torch.no_grad():
        out_t = mt(torch.from_numpy(x))
    for key, head, mul in (("rot_raw", "fc_rot", 1.0),
                           ("trans", "fc_trans", np.array([20.0, 20.0, 0.5]))):
        # Compare what the network adds to the heads' biases.
        bias = var["params"][head]["bias"].reshape(C, -1) * mul
        ref = np.asarray(out_j[key]) - bias
        got = out_t[key]
        assert got.dtype == torch.float32 and got.shape == ref.shape, key
        scale = np.abs(ref).max()
        assert scale > 1e-2, key  # the randomised heads make the net matter
        np.testing.assert_allclose(got.numpy() - bias, ref, rtol=0,
                                   atol=rel * scale, err_msg=key)


def test_forward_f32():
    _compare((64, 128))


def test_forward_odd_size_asymmetric_same_pads():
    _compare((50, 70))


def test_forward_coarse_head_grid_resize():
    # 64x96 gives a 1x2 bottleneck, bilinearly upsampled to the 2x3 grid.
    _compare((64, 96), head_grid=(2, 3))


def test_forward_bf16_against_f32_reference():
    # bf16 convs/fc1/fc2 (float32 heads) against the float32 reference:
    # bf16 keeps 8 mantissa bits, so 10 layers drift a few percent.
    _compare((64, 128), dtype=torch.bfloat16, rel=5e-2)


def test_same_pad():
    assert fn_t.same_pad(480, 7, 2) == (2, 3)
    assert fn_t.same_pad(15, 3, 2) == (1, 1)
    assert fn_t.same_pad(20, 3, 2) == (0, 1)
    assert fn_t.same_pad(50, 3, 1) == (1, 1)
    assert fn_t.bottleneck_grid(480, 640) == fn_j.bottleneck_grid(480, 640)
    assert fn_t.bottleneck_grid(240, 330) == fn_j.bottleneck_grid(240, 330)


def test_bridge_round_trip_exact():
    _, var, mt = _models((64, 128))
    sd = mt.state_dict()
    back = flax_to_torch(torch_to_flax(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    tree = torch_to_flax(sd)
    for name, sub in var["params"].items():
        flat = sub.get("Conv_0", sub)
        got = tree[name].get("Conv_0", tree[name])
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[leaf], flat[leaf])
    # The full tree (decoder and mask head) round-trips exactly too, from
    # flax and from torch; unknown subtrees are refused.
    full = _decoder_models((64, 128))[1]["params"]
    sd_full = flax_to_torch(full)
    assert len(sd_full) > len(sd) and sd.keys() <= sd_full.keys()
    back_full = flax_to_torch(torch_to_flax(sd_full))
    assert back_full.keys() == sd_full.keys()
    for k in sd_full:
        assert torch.equal(back_full[k], sd_full[k]), k
    flat_ref = jax.tree_util.tree_flatten_with_path(full)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(torch_to_flax(sd_full))[0])
    assert len(flat_got) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))
    with pytest.raises(KeyError):
        flax_to_torch(dict(var["params"], mystery={"kernel": np.zeros(1)}))


def test_init_draws_only_from_its_generator():
    state = torch.get_rng_state()
    a = fn_t.DeepIMFlowNet(input_size=(64, 64), generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), state)  # global RNG untouched
    b = fn_t.DeepIMFlowNet(input_size=(64, 64), generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    # flax's lecun_normal: variance 1 / fan_in, truncated at 2 std
    w = a.conv4_1.weight.detach()
    fan_in = w[0].numel()
    assert abs(float(w.var()) * fan_in - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 * (1.0 / fan_in) ** 0.5 / 0.87962566103423978


def test_identity_heads_and_helpers():
    mt = fn_t.DeepIMFlowNet(num_classes=C, input_size=(64, 64), dtype=torch.float32)
    with torch.no_grad():
        out = mt(torch.rand(2, 64, 64, 6))
    quat = fn_t.decode_rot(fn_t.select_class(out["rot_raw"], torch.tensor([0, 2])), "quat")
    np.testing.assert_array_equal(quat.numpy(), [[1, 0, 0, 0]] * 2)
    assert torch.count_nonzero(out["trans"]) == 0
    # int8 builds (tests/test_torch_quant.py); int8_static is int8 with
    # calibrated scales, never a model of its own
    assert fn_t.DeepIMFlowNet(input_size=(64, 64), quant="int8").quant == "int8"
    with pytest.raises(ValueError, match="quant"):
        fn_t.DeepIMFlowNet(input_size=(64, 64), quant="int8_static")
    rng = np.random.RandomState(4)
    per_class = rng.randn(5, C, 4).astype(np.float32)
    idx = np.array([0, 2, 1, 7, 2])  # 7 clamps to the last class
    np.testing.assert_array_equal(
        fn_t.select_class(torch.from_numpy(per_class), torch.from_numpy(idx)).numpy(),
        np.asarray(fn_j.select_class(jnp.asarray(per_class), jnp.asarray(idx))))
    eul = rng.randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(fn_t.decode_rot(torch.from_numpy(eul), "euler").numpy(),
                               np.asarray(fn_j.decode_rot(jnp.asarray(eul), "euler")),
                               atol=1e-5)
    depth = np.where(rng.rand(2, 8, 8) > 0.5, rng.uniform(0.3, 1.0, (2, 8, 8)), 0.0
                     ).astype(np.float32)
    z = np.array([0.5, 0.8], np.float32)
    np.testing.assert_allclose(
        fn_t.normalize_depth(torch.from_numpy(depth), torch.from_numpy(z)).numpy(),
        np.asarray(fn_j.normalize_depth(jnp.asarray(depth), jnp.asarray(z))), atol=1e-6)
    a, b = rng.rand(2, 4, 4, 3).astype(np.float32), rng.rand(2, 4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(
        fn_t.network_input(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(fn_j.network_input(jnp.asarray(a), jnp.asarray(b))))


# --- the decoder and mask heads ---------------------------------------------


def _decoder_models(input_size, pose_head="flatten", seed=0):
    """Flax and torch full networks (flow + mask) on shared random weights:
    every bias is randomised too (flax initialises them to 0), so a wrong
    bias mapping shows."""
    grid = fn_j.bottleneck_grid(*input_size)
    mj = fn_j.DeepIMFlowNet(num_classes=C, dtype=jnp.float32, head_grid=grid,
                            pose_head=pose_head)
    var = mj.init(jax.random.PRNGKey(seed), jnp.zeros((1, *input_size, 6)))
    params = randomize_heads(jax.tree.map(np.asarray, var["params"]), seed, 0.02)
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        if path[-1].key == "bias" and a.ndim == 1 and "fc_" not in str(path[0]) else a,
        params)
    mt = _torch_model(num_classes=C, head_grid=grid, dtype=torch.float32,
                      with_flow=True, with_mask=True, pose_head=pose_head)
    mt.load_state_dict(flax_to_torch(params))
    return mj, {"params": params}, mt


@pytest.mark.parametrize("input_size,pose_head", [
    ((48, 64), "flatten"),
    ((50, 70), "flatten"),  # odd skips: every deconv overshoots and is cropped
    ((48, 64), "gap"),
])
def test_decoder_and_mask_heads_match(input_size, pose_head):
    mj, var, mt = _decoder_models(input_size, pose_head)
    x = np.random.RandomState(2).uniform(-0.5, 0.5, (2, *input_size, 6)).astype(np.float32)
    out_j = mj.apply(var, jnp.asarray(x))
    with torch.no_grad():
        out_t = mt(torch.from_numpy(x))
        pose_only = mt(torch.from_numpy(x), pose_only=True)
    assert set(out_t["flow"]) == set(out_j["flow"]) == {6, 5, 4, 3, 2}
    for lvl, ref in out_j["flow"].items():
        got = out_t["flow"][lvl]
        assert got.dtype == torch.float32 and got.shape == ref.shape, lvl
        assert np.abs(np.asarray(ref)).max() > 1e-2, lvl
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4,
                                   err_msg=f"flow level {lvl}")
    ref = np.asarray(out_j["mask_logit"])
    assert out_t["mask_logit"].shape == ref.shape == (2, -(-input_size[0] // 4),
                                                       -(-input_size[1] // 4), 1)
    np.testing.assert_allclose(out_t["mask_logit"].numpy(), ref, rtol=0, atol=1e-4)
    for key in ("rot_raw", "trans"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]), rtol=0,
                                   atol=1e-4, err_msg=key)
        # The pose-only forward skips the decoder and gives the same pose.
        assert torch.equal(pose_only[key], out_t[key]), key
    assert set(pose_only) == {"rot_raw", "trans"}


@pytest.mark.parametrize("n", [(5, 8), (6, 7)])
def test_transposed_conv_padding_and_flip(n):
    """flax ConvTranspose 4x4/s2 SAME (kernel unflipped, dilated input
    padded by (2, 2)) == torch conv_transpose2d(padding=1) on the bridged
    (flipped) kernel: output 2n, at even and odd sizes."""
    from flax import linen as nn

    layer = nn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME")
    rng = np.random.RandomState(3)
    x = rng.randn(2, *n, 5).astype(np.float32)
    var = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = rng.randn(4, 4, 5, 3).astype(np.float32)  # not flip-symmetric
    bias = rng.randn(3).astype(np.float32)
    ref = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}},
                                 jnp.asarray(x)))
    assert ref.shape == (2, 2 * n[0], 2 * n[1], 3)
    sd = flax_to_torch({"upsample_flow6to5": {"kernel": kernel, "bias": bias}})
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), sd["upsample_flow6to5.weight"],
        sd["upsample_flow6to5.bias"], stride=2, padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # Without the flip the same layer is off: the flip is the trap.
    unflipped = torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (2, 3, 0, 1))))
    wrong = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), unflipped, torch.from_numpy(bias),
        stride=2, padding=1).permute(0, 2, 3, 1)
    assert np.abs(wrong.numpy() - ref).max() > 1e-1
    assert var["params"]["kernel"].shape == kernel.shape


def test_decoder_init_and_pose_only_load():
    # The decoder's weights are drawn after every other, so a model with
    # and one without the decoder share all other initial weights; a full
    # state_dict serves a pose-only model through load_params.
    from deepim_tpu_torch.train.checkpoint import load_params

    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    full = fn_t.DeepIMFlowNet(input_size=(64, 64), with_flow=True, with_mask=True,
                              generator=g())
    pose = fn_t.DeepIMFlowNet(input_size=(64, 64), generator=g())
    sd_full, sd_pose = full.state_dict(), pose.state_dict()
    for k, v in sd_pose.items():
        assert torch.equal(sd_full[k], v), k
    w = full.deconv4.weight.detach()  # (in, out, 4, 4): fan-in = in * 16
    assert abs(float(w.var()) * w.shape[0] * 16 - 1.0) < 0.05
    load_params(pose, sd_full)
    with pytest.raises(KeyError):
        load_params(pose, dict(sd_full, mystery=torch.zeros(1)))
    with pytest.raises(RuntimeError):  # a missing key still fails
        load_params(full, sd_pose)


# --- conv1: channels padded to a multiple of 8, folded by space-to-depth ----


@pytest.fixture(scope="module")
def conv1_net():
    """A float32 network at a tiny size (38 even: SAME pads conv1 (2, 3);
    53 odd: (3, 3)) whose pose heads are randomised, so conv1 gets a
    gradient, the only one it computes."""
    net = _torch_model(input_size=(38, 53), fc_dim=16, dtype=torch.float32)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for head in (net.fc_rot, net.fc_trans):
            head.weight.normal_(0.0, 0.1, generator=g)
    for p in net.parameters():  # only conv1's gradient is compared
        p.requires_grad_(p is net.conv1.weight)
    return net


def _net_input(cin, seed=5):
    x = np.random.RandomState(seed).uniform(-0.5, 0.5, (2, 38, 53, cin))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("mxnet_pad", [False, True])
def test_conv1_padded_channels_match_unpadded_conv(conv1_net, mxnet_pad, monkeypatch):
    # The network with conv1 on the 6-channel input zero-extended to 8 and
    # folded by space-to-depth, its border built in, against F.pad of the 6
    # channels and the 7x7 stride-2 F.conv2d: the pose outputs and conv1's
    # weight gradient.  float32: the fold sums conv1's taps in another
    # order (up to 6e-6 of scale measured over 8 inputs; float64 below).
    net = conv1_net
    monkeypatch.setattr(net, "mxnet_pad", mxnet_pad)
    x = _net_input(6)

    def run():
        net.zero_grad(set_to_none=True)
        out = net(x)
        (out["rot_raw"].square().sum() + out["trans"].square().sum()).backward()
        return out, net.conv1.weight.grad

    out, grad = run()
    monkeypatch.setattr(net, "_conv1", lambda c: net._conv(
        "conv1", c.permute(0, 3, 1, 2), net.mxnet_pad))
    ref, ref_grad = run()
    for got, want, what in ((out["rot_raw"], ref["rot_raw"], "rot_raw"),
                            (out["trans"], ref["trans"], "trans"),
                            (grad, ref_grad, "conv1 gradient")):
        scale = float(want.detach().abs().max())
        assert scale > 1e-6, what  # the heads make every number matter
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                                   atol=2e-5 * scale, err_msg=what)
    assert grad.shape == (64, 6, 7, 7)


@pytest.mark.parametrize("mxnet_pad", [False, True])
def test_conv1_fold_is_exact_in_float64(conv1_net, mxnet_pad, monkeypatch):
    # conv1 alone in float64: its output and its weight gradient (under a
    # random upstream gradient) against the unpadded 7x7 stride-2 conv.
    net = conv1_net
    monkeypatch.setattr(net, "mxnet_pad", mxnet_pad)
    monkeypatch.setattr(net, "dtype", torch.float64)
    x = _net_input(6)
    y = net._conv1(x)
    want = net._conv("conv1", x.double().permute(0, 3, 1, 2), mxnet_pad)
    up = torch.from_numpy(np.random.RandomState(6).randn(*want.shape))
    (grad,) = torch.autograd.grad((y * up).sum(), net.conv1.weight)
    (want_grad,) = torch.autograd.grad((want * up).sum(), net.conv1.weight)
    for got, ref, what in ((y, want, "conv1"), (grad, want_grad, "conv1 gradient")):
        scale = float(ref.detach().abs().max())
        assert got.shape == ref.shape and scale > 1e-3, what
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=what)


def test_conv1_weight_keeps_its_shape(conv1_net):
    assert conv1_net.conv1.weight.shape == (64, 6, 7, 7)
    assert conv1_net.state_dict()["conv1.weight"].shape == (64, 6, 7, 7)


@pytest.mark.parametrize("cin,cin_padded", [(6, 8), (8, 8), (10, 16)])
def test_conv1_span_reads_padded_channels(conv1_net, cin, cin_padded, monkeypatch):
    # 6 (neither mask nor depth input), 8 (one of them), 10 (both).
    from deepim_tpu_torch.utils import profiling

    monkeypatch.setattr(conv1_net, "conv1", torch.nn.Conv2d(cin, 64, 7, stride=2))
    profiling.clear_spans()
    with torch.no_grad(), torch.autograd.profiler.profile():
        conv1_net(_net_input(cin), pose_only=True)
    (span,) = [s for s in profiling.spans() if s.name == "network.conv1"]
    assert dict(span.attrs) == {"cin": cin, "cin_padded": cin_padded}
