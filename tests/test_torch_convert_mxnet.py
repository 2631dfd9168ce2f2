"""deepim_tpu_torch.train.convert_mxnet and ``mxnet_pad`` against MXNet's
semantics and against the JAX package (CPU).

Every case of ``tests/test_convert_math.py`` with torch oracles: MXNet's
``Convolution`` is ``conv2d`` with symmetric padding, and its
``Deconvolution`` is by definition the gradient of that conv with respect
to its input, taken here with ``torch.autograd.grad`` (the IOHW deconv
weight read as the conv's OIHW weight).  Then the whole network: one
``.npz`` converted by the reference (``convert_mxnet_dict`` on the flax
tree, then ``models/bridge.py``) and by the port gives the same torch
state bit for bit, at both ``flip_deconv`` values; the two networks with
``mxnet_pad`` on those weights agree within atol 1e-5 (float32; they sum
the convolutions in other orders); missing and mis-shaped layers are named
as the reference names them.

Tolerances: array equality where the reference's test has it (the deconv
flip, stride-1 and stride-2 convs); atol 2e-5 with rtol 1e-5 for conv1 on
the network input (the reference's stem case; its outputs reach ~20, and a
padded input and a padding conv sum 294 terms in other orders); 1e-5 for
the two-layer net; rtol 1e-6 for the dense layer; 1e-5 for the full
networks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepim_tpu.models import flownet as fn_j
from deepim_tpu.models.flownet import StemConv
from deepim_tpu.train import convert_mxnet as cm_j
from deepim_tpu_torch.models import flownet as fn_t
from deepim_tpu_torch.models.bridge import flax_to_torch
from deepim_tpu_torch.train import convert_mxnet as cm_t

rng = np.random.RandomState(0)


def mxnet_conv(x, w, stride, pad):
    """MXNet Convolution (symmetric pad, NCHW/OIHW)."""
    return F.conv2d(torch.as_tensor(x), torch.as_tensor(w), stride=stride, padding=pad)


def mxnet_deconv(x, w_iohw, stride, pad):
    """MXNet Deconvolution: the gradient of :func:`mxnet_conv` with respect
    to its input, the IOHW weight read as that conv's OIHW weight."""
    n, _, h, w = x.shape
    kh, kw = w_iohw.shape[2:]
    y = torch.zeros(n, w_iohw.shape[1], (h - 1) * stride - 2 * pad + kh,
                    (w - 1) * stride - 2 * pad + kw, requires_grad=True)
    out = mxnet_conv(y, w_iohw, stride, pad)
    (g,) = torch.autograd.grad(out, y, grad_outputs=torch.as_tensor(x))
    return g


def _model(**kw):
    return fn_t.DeepIMFlowNet(num_classes=2, input_size=(64, 64), fc_dim=16,
                              dtype=torch.float32, **kw)


def test_deconv_flip_is_exactly_mxnet_semantics():
    """MXNet's deconv weight converted at flip_deconv=True is the torch
    transposed conv's weight unflipped: equal to the autograd oracle bit for
    bit; at flip_deconv=False it is not."""
    x = rng.randn(2, 3, 8, 10).astype(np.float32)
    w = rng.randn(3, 5, 4, 4).astype(np.float32)  # IOHW
    oracle = mxnet_deconv(x, w, 2, 1)
    sd = {"deconv5.weight": torch.zeros(3, 5, 4, 4), "deconv5.bias": torch.zeros(5)}
    for flip, exact in ((True, True), (False, False)):
        new, missing = cm_t.convert_mxnet_dict({"arg:deconv5_weight": w}, sd, flip_deconv=flip)
        assert not missing
        out = F.conv_transpose2d(torch.from_numpy(x), new["deconv5.weight"], stride=2, padding=1)
        if exact:
            assert torch.equal(out, oracle)
            assert torch.equal(new["deconv5.weight"], torch.from_numpy(w))
        else:
            assert (out - oracle).abs().max() > 1.0  # the flip is load-bearing


def test_conv_stride1_same_equals_mxnet():
    x = torch.from_numpy(rng.randn(2, 256, 9, 11).astype(np.float32))
    m = _model()
    w = torch.from_numpy(rng.randn(256, 256, 3, 3).astype(np.float32) * 0.05)
    m.conv3_1.weight.data.copy_(w)
    m.conv3_1.bias.data.zero_()
    oracle = F.leaky_relu(mxnet_conv(x, w, 1, 1), 0.1)
    for sym in (False, True):  # SAME and k//2 coincide at stride 1
        assert torch.equal(m._conv("conv3_1", x, sym), oracle)


@pytest.mark.parametrize("name,k,cin", [("conv1", 7, 6), ("conv2", 5, 64)])
def test_conv_stride2_needs_mxnet_pad(name, k, cin):
    """conv1 (7x7/s2) and conv2 (5x5/s2): SAME shifts the taps by one
    pixel; mxnet_pad is exact."""
    x = torch.from_numpy(rng.randn(2, cin, 16, 20).astype(np.float32))
    m = _model()
    conv = getattr(m, name)
    w = torch.from_numpy(rng.randn(*conv.weight.shape).astype(np.float32))
    conv.weight.data.copy_(w)
    conv.bias.data.zero_()
    oracle = F.leaky_relu(mxnet_conv(x, w, 2, k // 2), 0.1)
    assert torch.equal(m._conv(name, x, sym=True), oracle)
    assert (m._conv(name, x) - oracle).abs().max() > 1e-3  # SAME is not MXNet's


def test_conv1_on_the_network_input_honours_mxnet_pad():
    """The reference's stem case (its space-to-depth conv1 under
    mxnet_pad): the port's conv1 as the forward runs it (channels padded
    to 8, folded by space-to-depth) on a 6-channel input of even size,
    inside a model built with mxnet_pad=True, against the MXNet oracle and
    the reference's StemConv."""
    x = rng.randn(2, 6, 16, 20).astype(np.float32)
    w = rng.randn(64, 6, 7, 7).astype(np.float32)
    oracle = F.leaky_relu(mxnet_conv(x, w, 2, 3), 0.1)
    m = _model(mxnet_pad=True)
    m.conv1.weight.data.copy_(torch.from_numpy(w))
    m.conv1.bias.data.zero_()
    with torch.no_grad():
        got = m._conv1(torch.from_numpy(x).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5, atol=2e-5)
    stem = StemConv(64, 7, 2, jnp.float32, True)
    var = {"params": {"Conv_0": {"kernel": jnp.asarray(cm_j.conv_oihw_to_hwio(w)),
                                 "bias": jnp.zeros(64)}}}
    ref = stem.apply(var, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), rtol=1e-5,
                               atol=2e-5)


def test_dense_transpose():
    x = rng.randn(3, 7).astype(np.float32)
    w = rng.randn(4, 7).astype(np.float32)  # MXNet FC: (out, in)
    b = rng.randn(4).astype(np.float32)
    sd = {"fc1.weight": torch.zeros(4, 7), "fc1.bias": torch.zeros(4)}
    new, missing = cm_t.convert_mxnet_dict({"arg:fc1_weight": w, "arg:fc1_bias": b}, sd)
    assert not missing
    out = F.linear(torch.from_numpy(x), new["fc1.weight"], new["fc1.bias"])
    np.testing.assert_allclose(out.numpy(), x @ w.T + b, rtol=1e-6)


def test_two_layer_fixture_net_golden():
    """conv (5x5/s2) -> leaky -> deconv (4x4/s2) -> leaky: the MXNet oracle
    against the port's layers on converted weights."""
    x = torch.from_numpy(rng.randn(1, 64, 12, 16).astype(np.float32))
    w_conv = rng.randn(128, 64, 5, 5).astype(np.float32) * 0.05
    b_conv = rng.randn(128).astype(np.float32)
    w_dec = rng.randn(1024, 512, 4, 4).astype(np.float32) * 0.05  # deconv5's IOHW
    b_dec = rng.randn(512).astype(np.float32)
    h = F.leaky_relu(mxnet_conv(x, w_conv, 2, 2) + torch.from_numpy(b_conv)[:, None, None], 0.1)
    h6 = torch.cat([h] * 8, 1)  # deconv5 reads 1,024 channels
    oracle = F.leaky_relu(mxnet_deconv(h6.numpy(), w_dec, 2, 1)
                          + torch.from_numpy(b_dec)[:, None, None], 0.1)

    m = _model(with_flow=True, mxnet_pad=True)
    sd, missing = cm_t.convert_mxnet_dict(
        {"arg:conv2_weight": w_conv, "arg:conv2_bias": b_conv,
         "arg:deconv5_weight": w_dec, "arg:deconv5_bias": b_dec}, m.state_dict())
    assert {"conv2", "deconv5"}.isdisjoint(missing)
    m.load_state_dict(sd)
    with torch.no_grad():
        out = fn_t.leaky(m._up("deconv5", torch.cat([m._conv("conv2", x, True)] * 8, 1)))
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=1e-5)


def _jax_model():
    mj = fn_j.DeepIMFlowNet(num_classes=2, fc_dim=16, with_flow=True, with_mask=True,
                            dtype=jnp.float32, mxnet_pad=True)
    var = mj.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 6)))
    params = jax.tree.map(np.asarray, var["params"])
    for head in ("fc_rot", "fc_trans"):  # make the pose heads carry the net
        params[head] = {k: (v + 0.5 * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in params[head].items()}
    return mj, params


def test_full_model_mxnet_roundtrip_with_pad_mode(tmp_path):
    """Export a small mxnet_pad model's weights, convert them back, and get
    the same outputs (the reference's slow case, run here)."""
    m = _model(with_flow=True, with_mask=True, mxnet_pad=True,
               generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "w.npz")
    cm_t.export_mxnet_npz(m.state_dict(), path)
    new, missing = cm_t.convert_mxnet_dict(cm_t.load_mxnet_npz(path), m.state_dict(),
                                           strict=True)
    assert not missing
    x = torch.from_numpy(rng.randn(2, 64, 64, 6).astype(np.float32))
    m2 = _model(with_flow=True, with_mask=True, mxnet_pad=True,
                generator=torch.Generator().manual_seed(9))
    m2.load_state_dict(new)
    with torch.no_grad():
        ref, out = m(x), m2(x)
    for key in ("rot_raw", "trans", "mask_logit"):
        assert torch.equal(out[key], ref[key]), key
    assert torch.equal(out["flow"][2], ref["flow"][2])


@pytest.mark.parametrize("flip", [True, False])
def test_one_npz_two_converters_same_state_and_outputs(tmp_path, flip):
    """One .npz (the reference's export of a flax mxnet_pad model):
    converted by the reference and bridged, and converted by the port, at
    ``flip_deconv=flip`` -> the same state_dict bit for bit; the two
    networks on it agree within 1e-5."""
    mj, params = _jax_model()
    path = str(tmp_path / "ref.npz")
    cm_j.export_flax_to_mxnet_npz(params, path)
    mx = cm_j.load_mxnet_npz(path)
    np.testing.assert_equal(cm_t.load_mxnet_npz(path), mx)
    conv_j, missing_j = cm_j.convert_mxnet_dict(mx, params, flip_deconv=flip, strict=True)
    m = _model(with_flow=True, with_mask=True, mxnet_pad=True)
    sd, missing_t = cm_t.convert_mxnet_dict(mx, m.state_dict(), flip_deconv=flip, strict=True)
    assert missing_j == missing_t == []
    bridged = flax_to_torch(conv_j)
    assert sd.keys() == bridged.keys()
    for key in sd:
        assert torch.equal(sd[key], bridged[key]), key
    m.load_state_dict(sd)
    x = rng.uniform(-0.5, 0.5, (2, 64, 64, 6)).astype(np.float32)
    out_j = mj.apply({"params": conv_j}, jnp.asarray(x))
    with torch.no_grad():
        out_t = m(torch.from_numpy(x))
    for key in ("rot_raw", "trans", "mask_logit"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]), atol=1e-5,
                                   err_msg=key)
    for lvl in (2, 6):
        np.testing.assert_allclose(out_t["flow"][lvl].numpy(), np.asarray(out_j["flow"][lvl]),
                                   atol=1e-5)
    assert np.abs(np.asarray(out_j["rot_raw"])).max() > 1e-2  # the net carries the heads


def test_port_export_converts_in_the_reference(tmp_path):
    """export_mxnet_npz is the reference's exporter composed with the
    bridge: the reference converts the port's file into the port's weights."""
    m = _model(with_flow=True, with_mask=True, mxnet_pad=True)
    path = str(tmp_path / "port.npz")
    cm_t.export_mxnet_npz(m.state_dict(), path)
    _, params = _jax_model()
    conv_j, missing = cm_j.convert_mxnet_dict(cm_j.load_mxnet_npz(path), params, strict=True)
    assert not missing
    back = flax_to_torch(conv_j)
    for key, v in m.state_dict().items():
        assert torch.equal(back[key], v), key


def test_missing_and_mismatched_layers_are_named_as_the_reference_names_them(tmp_path):
    mj, params = _jax_model()
    path = str(tmp_path / "ref.npz")
    cm_j.export_flax_to_mxnet_npz(params, path)
    mx = dict(cm_j.load_mxnet_npz(path))
    del mx["arg:fc_rot_weight"], mx["arg:predict_flow6_weight"]
    mx["arg:conv4_weight"] = mx["arg:conv4_weight"][:, :8]  # wrong input width
    _, missing_j = cm_j.convert_mxnet_dict(mx, params)
    m = _model(with_flow=True, with_mask=True, mxnet_pad=True)
    sd, missing_t = cm_t.convert_mxnet_dict(mx, m.state_dict())
    assert sorted(missing_t) == sorted(missing_j) == sorted(
        ["fc_rot", "predict_flow6", "conv4 (shape mismatch)"])
    assert torch.equal(sd["conv4.weight"], m.state_dict()["conv4.weight"])  # kept its init
    with pytest.raises(ValueError, match="conv4"):
        cm_t.convert_mxnet_dict(mx, m.state_dict(), strict=True)


def test_make_model_builds_mxnet_pad():
    from deepim_tpu_torch.config import config_from_dict
    from deepim_tpu_torch.train.train import make_model

    cfg = config_from_dict({"network": {"mxnet_pad": True, "input_height": 64,
                                        "input_width": 64, "fc_dim": 16}})
    assert make_model(cfg, 2).mxnet_pad and make_model(cfg, 2, inference=True).mxnet_pad
    src = open(os.path.join(os.path.dirname(fn_t.__file__), "..", "train", "train.py")).read()
    assert "mxnet_pad" in src and "NotImplementedError(\"network.mxnet_pad" not in src
