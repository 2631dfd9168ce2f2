"""int8 inference of the port (``deepim_tpu_torch.models.flownet`` int8,
``models/quant.py``) on the CPU.

Two groups.  The first mirrors each test of ``tests/test_quant.py`` on the
port alone.  The second holds the port against ``deepim_tpu`` on the same
numpy inputs and the same weights (``models/bridge.py §flax_to_torch``):

- int8 values, scales and int32 products are equal, exactly: both sides
  divide in IEEE float32 and round half to even, and integer sums are
  exact;
- the whole int8 model at float32 agrees to 1e-5 of the outputs' scale:
  the encoder and fc1/fc2 are bit for bit equal, and only the float32
  fc_rot/fc_trans matmuls sum in another order (~1e-7);
- at bfloat16 the two sides round the leaky's 0.1 differently (flax
  multiplies by bf16(0.1), torch by float32 0.1 before rounding), so a
  few int8 values flip by one step: 5e-2 of the scale, the port's bf16
  tolerance for the plain network (tests/test_torch_flownet.py);
- calibration on shared inputs: the same layer names; scalar scales
  within rtol 1e-6 (the percentile uses the reference's float32
  interpolation), per-channel ones within 1e-2 of the layer's largest
  scale: XLA fuses the reference's recording graph with other roundings
  (its statistics differ from its own activations by an ulp), and an ulp
  in one activation flips an int8 value downstream (5.7e-3 measured);
  through each package's own refine loop within rtol 5e-2 (the two
  rasterizers can place an edge pixel differently, which moves later
  iterations' activations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepim_tpu.models import flownet as fn_j
from deepim_tpu_torch.models import flownet as fn_t
from deepim_tpu_torch.models import quant as q_t
from deepim_tpu_torch.models.bridge import flax_to_torch

LAYERS = ("conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1",
          "conv5", "conv5_1", "conv6", "conv6_1", "fc1", "fc2")
HW = (64, 64)


def _model(quant="int8", dtype=torch.float32, hw=HW, seed=1, **kw):
    return fn_t.DeepIMFlowNet(num_classes=2, input_size=hw, fc_dim=32, dtype=dtype,
                              quant=quant, generator=torch.Generator().manual_seed(seed), **kw)


def _randomize_heads(model, seed=5, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for head in (model.fc_rot, model.fc_trans):
            for p in head.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * scale)
    return model


def _x(seed, shape=(2, *HW, 6), scale=1.0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale


def _rel(got, ref):
    scale = max(ref.abs().max().item(), 1e-3)
    return (got - ref).abs().max().item() / scale


# -- mirror of tests/test_quant.py -------------------------------------------------

def test_quant_state_dict_matches_plain():
    plain = _model("none", with_flow=True, with_mask=True)
    quant = _model("int8", with_flow=True, with_mask=True)
    sp, sq = plain.state_dict(), quant.state_dict()
    assert list(sp) == list(sq)
    for k in sp:
        assert torch.equal(sp[k], sq[k]), k
    # act_scales is a plain attribute: neither parameter nor buffer
    twin = quant.with_act_scales((("conv1", 0.5),))
    assert list(twin.state_dict()) == list(sp)
    assert not any("act_scales" in k for k, _ in twin.named_buffers())
    # the decoder and mask head stay float on the int8 encoder's skips
    with torch.no_grad():
        out_p, out_q = plain(_x(1)), quant(_x(1))
    assert out_q["mask_logit"].shape == out_p["mask_logit"].shape
    assert {k: v.shape for k, v in out_q["flow"].items()} == {
        k: v.shape for k, v in out_p["flow"].items()}
    assert _rel(out_q["mask_logit"], out_p["mask_logit"]) < 0.1


def test_quant_stats_only_while_recording():
    model = _model()
    x = _x(0)
    model(x, pose_only=True)
    assert model._calib_stats is None
    with fn_t.recording_stats(model, fn_t.CALIB_STATS) as stats:
        model(x, pose_only=True)
    assert model._calib_stats is None
    for layer in LAYERS:
        assert layer in stats, layer
        assert stats[layer]["amax"].shape == ()


def test_int8_static_calibration_roundtrip():
    model = _randomize_heads(_model("none"))
    x1, x2 = _x(2, scale=0.3), _x(3, scale=0.5)
    scales = q_t.calibrate_act_scales(model, [x1, x2])
    names = [n for n, _ in scales]
    assert "conv1" in names and "fc1" in names
    assert all(s > 0 for _, s in scales)
    static = model.with_act_scales(scales)
    # the static path records nothing
    with fn_t.recording_stats(static, fn_t.CALIB_STATS) as stats:
        out_s = static(x1, pose_only=True)
    assert not stats
    out_d = model.with_act_scales(())(x1, pose_only=True)
    for key in ("rot_raw", "trans"):
        assert _rel(out_s[key], out_d[key]) < 0.1, key


def test_calibrate_model_from_eval_batches():
    from deepim_tpu_torch.geometry.symmetry import rot_z_syms
    from deepim_tpu_torch.models.flownet import bottleneck_grid
    from deepim_tpu_torch.raster.mesh import box_mesh, icosphere_mesh
    from deepim_tpu_torch.refine import build_assets

    assets = build_assets([box_mesh((0.08, 0.1, 0.06)), icosphere_mesh(0.05)],
                          sym_transforms=[rot_z_syms(2), None], num_points=64, device="cpu")
    h, w = 64, 128
    k_cam = torch.tensor([[300.0, 0, 64], [0, 300, 32], [0, 0, 1]])
    model = fn_t.DeepIMFlowNet(num_classes=2, dtype=torch.float32, fc_dim=32,
                               head_grid=bottleneck_grid(h, w), quant="int8")
    pose = torch.tensor([[1.0, 0, 0, 0.02], [0, 1, 0, 0.0], [0, 0, 1, 0.6]]).expand(2, 3, 4)
    batch = {"obs_rgb": torch.rand(2, h, w, 3, generator=torch.Generator().manual_seed(1)),
             "pose_src": pose.contiguous(), "class_idx": torch.tensor([0, 1])}
    calibrated = q_t.calibrate_model(model, assets, [batch], k_cam, (h, w))
    assert calibrated.quant == "int8"
    assert len(calibrated.act_scales) >= 12
    assert calibrated.fc1.weight is model.fc1.weight  # shares the parameters
    out = calibrated(torch.zeros(2, h, w, 6), pose_only=True)
    assert out["trans"].shape == (2, 2, 3)


def test_config_rejects_bad_quant():
    from deepim_tpu_torch.config import config_from_dict

    with pytest.raises(ValueError, match="quant"):
        config_from_dict({"network": {"quant": "in8"}})
    for ok in ("none", "int8", "int8_static"):
        config_from_dict({"network": {"quant": ok}})
    with pytest.raises(ValueError, match="quant"):
        _model("int8_static")


def _q_np(a, axes):
    amax = np.maximum(np.abs(a).max(axis=axes, keepdims=True), 1e-12)
    s = amax / 127.0
    return np.clip(np.round(a / s), -127, 127), s


def test_int8_conv_matches_numpy_oracle():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 12, 5).astype(np.float32)
    k = rng.randn(3, 3, 5, 7).astype(np.float32)  # HWIO
    y = fn_t.int8_conv(torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                       1, (1, 1, 1, 1)).numpy()
    xq, sx = _q_np(x, (1, 2, 3))
    kq, sk = _q_np(k, (0, 1, 2))
    xp = np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.zeros((2, 10, 12, 7))
    for i in range(10):
        for j in range(12):
            ref[:, i, j, :] = np.einsum("bhwc,hwco->bo", xp[:, i:i + 3, j:j + 3, :], kq)
    ref = ref * sx * sk.reshape(1, 1, 1, -1)
    np.testing.assert_allclose(y, ref, rtol=1e-6, atol=1e-6)


def test_quantize_int8_scale_and_range():
    q, s = fn_t.quantize_int8(torch.tensor([[0.0, -2.0, 1.0, 0.5]]), (1,))
    assert q.dtype == torch.int8
    np.testing.assert_allclose(s.numpy(), 2.0 / 127.0, rtol=1e-6)
    np.testing.assert_array_equal(q.numpy(), [[0, -127, 64, 32]])


def test_int8_linear_matches_dense_closely():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, generator=g)
    lin = torch.nn.Linear(64, 16)
    with torch.no_grad():
        y_ref = lin(x)
        y_q = fn_t.int8_linear(x, lin.weight, lin.bias)
    assert (y_q - y_ref).abs().max() / y_ref.abs().max() < 0.02


def test_quant_conv_matches_f32_closely():
    x = _x(7, (2, 16, 16, 6))
    conv = torch.nn.Conv2d(6, 8, 3, stride=2)
    pads = (*fn_t.same_pad(16, 3, 2), *fn_t.same_pad(16, 3, 2))
    with torch.no_grad():
        xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (pads[2], pads[3], pads[0], pads[1]))
        y_ref = fn_t.leaky(torch.nn.functional.conv2d(xp, conv.weight, conv.bias, 2))
        y_q = fn_t.leaky(fn_t.int8_conv(x, conv.weight, 2, pads) + conv.bias).permute(0, 3, 1, 2)
    assert (y_q - y_ref).abs().max() / y_ref.abs().max() < 0.03


def test_quant_model_pose_outputs_close():
    plain = _randomize_heads(_model("none"))
    quant = plain.with_act_scales(())
    x = _x(0, scale=0.3)
    out_ref, out_q = plain(x, pose_only=True), quant(x, pose_only=True)
    for key in ("rot_raw", "trans"):
        assert _rel(out_q[key], out_ref[key]) < 0.08, key


def test_calibration_stats_all_modes():
    model = _model()
    with fn_t.recording_stats(model, fn_t.CALIB_STATS) as stats:
        model(_x(0), pose_only=True)
    st = stats["conv2"]
    c_in = st["amax_c"].shape[0]
    assert st["amax"].shape == () and st["p999"].shape == ()
    assert st["p999_c"].shape == (c_in,) and c_in == 64
    assert float(st["p999"]) <= float(st["amax"]) + 1e-6
    assert bool((st["p999_c"] <= st["amax_c"] + 1e-6).all())
    assert float(st["amax"]) == float(st["amax_c"].max())


def test_calibrate_modes_output_types_and_accuracy():
    model = _model("none")
    x = _x(2, (4, *HW, 6), scale=0.3)
    out_ref = model(x, pose_only=True)
    by_mode = {}
    for mode in q_t.CALIB_MODES:
        scales = q_t.calibrate_act_scales(model, [x], mode=mode)
        by_mode[mode] = dict(scales)
        out_s = model.with_act_scales(scales)(x, pose_only=True)
        for key in ("rot_raw", "trans"):
            assert _rel(out_s[key], out_ref[key]) < 0.15, (mode, key)
    for name, s in by_mode["max"].items():
        assert isinstance(s, float) and isinstance(by_mode["p999"][name], float)
        assert by_mode["p999"][name] <= s + 1e-9
        sc = by_mode["max_c"][name]
        assert isinstance(sc, tuple) and all(isinstance(v, float) for v in sc)
        assert abs(max(sc) - s) < 1e-6 * max(s, 1.0), name


def test_int8_conv_per_channel_fold_oracle():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    k = rng.randn(3, 3, 3, 4).astype(np.float32)
    s_c = (0.01, 0.05, 0.2)
    got = fn_t.int8_conv(torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                         1, (1, 1, 1, 1), act_scale=s_c).numpy()
    s = np.asarray(s_c, np.float32)
    xq = np.clip(np.round(x / s), -127, 127)
    kq, sk = _q_np(k * s.reshape(1, 1, 3, 1), (0, 1, 2))
    ref = jax.lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(kq), (1, 1), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(got, np.asarray(ref) * sk.reshape(1, 1, 1, -1),
                               rtol=1e-5, atol=1e-5)


# -- the port against deepim_tpu ---------------------------------------------------

@pytest.mark.parametrize("shape,dims", [((2, 9, 11, 6), (1, 2, 3)), ((3, 40), (1,)),
                                        ((3, 3, 6, 16), (0, 1, 2))])
def test_quantize_int8_equals_reference(shape, dims):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32) * 3
    qj, sj = fn_j._quantize_int8(jnp.asarray(x), dims)
    qt, st = fn_t.quantize_int8(torch.from_numpy(x), dims)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("scale", [0.0137, (0.011, 0.02, 0.005, 0.031, 0.017, 0.009)])
def test_quantize_int8_static_equals_reference(scale):
    x = np.random.RandomState(1).randn(2, 9, 11, 6).astype(np.float32) * 0.2
    # values on the .5 rounding boundaries, where a reciprocal multiply flips
    x[0, 0, 0, :] = np.float32(2.5) * np.asarray(scale, np.float32)
    qj = fn_j._quantize_int8_static(jnp.asarray(x), scale)
    qt = fn_t.quantize_int8_static(torch.from_numpy(x), scale)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def _conv_case(mode, stride, mxnet, k=7, c=6, o=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 30, 34, c).astype(np.float32)
    kern = (rng.randn(k, k, c, o) * 0.1).astype(np.float32)
    scale = {"dynamic": None, "scalar": 0.013,
             "per_channel": tuple(float(v) for v in rng.uniform(0.005, 0.02, c))}[mode]
    p = k // 2
    pad_j = ((p, p), (p, p)) if mxnet else "SAME"
    pads_t = (p,) * 4 if mxnet else (*fn_t.same_pad(30, k, stride),
                                     *fn_t.same_pad(34, k, stride))
    return x, kern, scale, pad_j, pads_t


@pytest.mark.parametrize("mode", ["dynamic", "scalar", "per_channel"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mxnet", [False, True])
def test_int8_conv_equals_reference(mode, stride, mxnet):
    """conv1's depth K = 7*7*6 = 294 (padded to 296 for the card): equal
    int32 products on equal operands, and equal dequantized outputs."""
    x, kern, scale, pad_j, pads_t = _conv_case(mode, stride, mxnet)
    w_t = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy())
    # the int32 products on the same int8 operands
    xq, _ = fn_j._quantize_int8(jnp.asarray(x), (1, 2, 3))
    kq, _ = fn_j._quantize_int8(jnp.asarray(kern), (0, 1, 2))
    prod_j = jax.lax.conv_general_dilated(xq, kq, (stride, stride), pad_j,
                                          dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                          preferred_element_type=jnp.int32)
    prod_t = fn_t.conv_int32(torch.from_numpy(np.asarray(xq)),
                             torch.from_numpy(np.asarray(kq).transpose(3, 2, 0, 1).copy()),
                             stride, pads_t)
    assert prod_t.dtype == torch.int32
    np.testing.assert_array_equal(prod_t.numpy(), np.asarray(prod_j))
    # the whole quantized conv
    y_j = fn_j._int8_conv(jnp.asarray(x), jnp.asarray(kern), (stride, stride), pad_j,
                          act_scale=scale)
    y_t = fn_t.int8_conv(torch.from_numpy(x), w_t, stride, pads_t, act_scale=scale)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


def test_int8_conv_batch_chunks_equal_one_pass(monkeypatch):
    x, kern, _, _, pads_t = _conv_case("dynamic", 2, False, seed=4)
    xq, _ = fn_t.quantize_int8(torch.from_numpy(x), (1, 2, 3))
    wq, _ = fn_t.quantize_int8(torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()), (1, 2, 3))
    whole = fn_t.conv_int32(xq, wq, 2, pads_t)
    monkeypatch.setattr(fn_t, "PATCH_BYTES", 1)  # one sample a chunk
    assert torch.equal(fn_t.conv_int32(xq, wq, 2, pads_t), whole)


def test_int_mm_pads_rows_depth_and_width_for_the_card(monkeypatch):
    """The card's _int_mm takes rows > 16 and depth and width multiples of
    8: conv1's 7*7*6 = 294 columns reach it as 296, a batch of 3 rows as
    17, a width of 20 as 24; the result is the unpadded product."""
    seen = []
    real = torch._int_mm

    def checked(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", checked)
    xq = torch.randint(-127, 128, (1, 3, 3, 6), dtype=torch.int8)
    cols = fn_t.im2col_int8(xq, 7, 2, (3, 3, 3, 3))
    assert cols.shape == (4, 296) and not cols[:, 294:].any()
    a = torch.randint(-127, 128, (3, 90), dtype=torch.int8)
    w = torch.randint(-127, 128, (20, 90), dtype=torch.int8)
    y = fn_t.int_mm(a, w)
    assert seen == [((17, 96), (96, 24))]
    assert y.dtype == torch.int32 and torch.equal(y, a.int() @ w.int().t())


@pytest.mark.parametrize("mode", ["dynamic", "scalar", "per_feature"])
@pytest.mark.parametrize("rows", [3, 20])
def test_int8_linear_equals_reference(mode, rows):
    from flax import linen as nn

    rng = np.random.RandomState(rows)
    x = rng.randn(rows, 90).astype(np.float32)
    scale = {"dynamic": None, "scalar": 0.021,
             "per_feature": tuple(float(v) for v in rng.uniform(0.01, 0.03, 90))}[mode]
    qd = fn_j.QDense(24, act_scale=scale)
    var = qd.init(jax.random.PRNGKey(1), jnp.asarray(x))
    var = {"params": {"kernel": np.asarray(var["params"]["kernel"]),
                      "bias": rng.randn(24).astype(np.float32)}}
    y_j = np.asarray(qd.apply(var, jnp.asarray(x)))
    y_t = fn_t.int8_linear(torch.from_numpy(x),
                           torch.from_numpy(var["params"]["kernel"].T.copy()),
                           torch.from_numpy(var["params"]["bias"]), act_scale=scale)
    np.testing.assert_array_equal(y_t.numpy(), y_j)
    del nn


def _shared(dtype_j=jnp.float32, dtype_t=torch.float32, hw=(64, 80), mxnet=False):
    mj = fn_j.DeepIMFlowNet(num_classes=2, dtype=dtype_j, with_flow=False, with_mask=False,
                            fc_dim=32, quant="int8", mxnet_pad=mxnet)
    var = mj.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 6)))
    params = jax.tree.map(np.asarray, var["params"])
    rng = np.random.RandomState(0)
    for head in ("fc_rot", "fc_trans"):
        params[head] = {k: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in params[head].items()}
    mt = fn_t.DeepIMFlowNet(num_classes=2, input_size=hw, fc_dim=32, dtype=dtype_t,
                            quant="int8", mxnet_pad=mxnet)
    mt.load_state_dict(flax_to_torch(params))
    return mj, {"params": params}, mt


def _inputs(seed, hw=(64, 80), b=3):
    return np.random.RandomState(seed).uniform(-0.5, 0.5, (b, *hw, 6)).astype(np.float32)


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("mxnet", [False, True])
def test_int8_model_matches_reference(dtype, rel, mxnet):
    mj, var, mt = _shared(getattr(jnp, dtype), getattr(torch, dtype), mxnet=mxnet)
    x = _inputs(1)
    out_j = mj.apply(var, jnp.asarray(x), pose_only=True)
    with torch.no_grad():
        out_t = mt(torch.from_numpy(x))
    for key in ("rot_raw", "trans"):
        ref = np.asarray(out_j[key])
        got = out_t[key].numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape, key
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale, err_msg=key)


@pytest.mark.parametrize("mode", ["max", "p999", "max_c", "p999_c"])
def test_calibrate_act_scales_matches_reference(mode):
    from deepim_tpu.models.quant import calibrate_act_scales as cal_j

    mj, var, mt = _shared()
    plain_j = mj.clone(quant="none")
    xs = [_inputs(2), _inputs(3) * 0.5]
    s_j = cal_j(plain_j, var, [jnp.asarray(x) for x in xs], mode=mode)
    s_t = q_t.calibrate_act_scales(mt, [torch.from_numpy(x) for x in xs], mode=mode)
    assert [n for n, _ in s_t] == [n for n, _ in s_j]
    for (name, a), (_, b) in zip(s_t, s_j):
        assert type(a) is type(b), name
        a, b = np.asarray(a), np.asarray(b)
        if mode.endswith("_c"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * np.abs(b).max(), err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ["max", "max_c"])
def test_reference_act_scales_give_reference_outputs(mode):
    """act_scales from deepim_tpu's calibrate_act_scales, loaded into the
    port, give the reference's outputs with the same scales."""
    from deepim_tpu.models.quant import calibrate_act_scales as cal_j

    mj, var, mt = _shared()
    scales = cal_j(mj, var, [jnp.asarray(_inputs(4))], mode=mode)
    x = _inputs(5)
    out_j = mj.clone(act_scales=scales).apply(var, jnp.asarray(x), pose_only=True)
    with torch.no_grad():
        out_t = mt.with_act_scales(scales)(torch.from_numpy(x))
    for key in ("rot_raw", "trans"):
        ref = np.asarray(out_j[key])
        np.testing.assert_allclose(out_t[key].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=key)


def test_calibrate_model_matches_reference_refine_loop():
    """Each package calibrates through its own refine loop on the same batch
    and weights: the same layers, scales within 5e-2."""
    from deepim_tpu.models.quant import calibrate_model as calm_j
    from deepim_tpu.raster import mesh as mesh_j
    from deepim_tpu.refine import build_assets as assets_j
    from deepim_tpu_torch.refine import build_assets as assets_t

    hw = (64, 128)
    grid = fn_j.bottleneck_grid(*hw)
    mj = fn_j.DeepIMFlowNet(num_classes=2, dtype=jnp.float32, with_flow=False,
                            with_mask=False, fc_dim=32, head_grid=grid, quant="int8")
    var = mj.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 6)))
    params = jax.tree.map(np.asarray, var["params"])
    mt = fn_t.DeepIMFlowNet(num_classes=2, head_grid=grid, fc_dim=32, dtype=torch.float32,
                            quant="int8")
    mt.load_state_dict(flax_to_torch(params))
    meshes = [mesh_j.box_mesh((0.08, 0.1, 0.06)), mesh_j.icosphere_mesh(0.05)]
    k_cam = np.array([[300.0, 0, 64], [0, 300, 32], [0, 0, 1]], np.float32)
    pose = np.tile(np.array([[1.0, 0, 0, 0.02], [0, 1, 0, 0.0], [0, 0, 1, 0.6]],
                            np.float32)[None], (2, 1, 1))
    obs = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    cls = np.array([0, 1], np.int32)
    cal_j = calm_j(mj, {"params": params}, assets_j(meshes, num_points=64),
                   [{"obs_rgb": jnp.asarray(obs), "pose_src": jnp.asarray(pose),
                     "class_idx": jnp.asarray(cls)}], jnp.asarray(k_cam), hw,
                   renderer="pallas_interpret", num_iters=2)
    cal_t = q_t.calibrate_model(mt, assets_t(meshes, num_points=64, device="cpu"),
                                [{"obs_rgb": torch.from_numpy(obs),
                                  "pose_src": torch.from_numpy(pose),
                                  "class_idx": torch.from_numpy(cls).long()}],
                                torch.from_numpy(k_cam), hw, num_iters=2)
    assert [n for n, _ in cal_t.act_scales] == [n for n, _ in cal_j.act_scales]
    for (name, a), (_, b) in zip(cal_t.act_scales, cal_j.act_scales):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-2, err_msg=name)
