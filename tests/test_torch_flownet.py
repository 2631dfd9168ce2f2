"""deepim_tpu_torch.models (pose-only DeepIMFlowNet + bridge) vs flax.

Shared random weights go through models/bridge.py; the zero-initialised
pose heads are randomised at a small scale so the outputs carry the whole
network.  float32 on both sides: rot_raw/trans agree to 1e-4 of their
scale (the convolutions sum in another order).
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


def _models(input_size, head_grid=None, dtype=torch.float32):
    mj = fn_j.DeepIMFlowNet(num_classes=C, dtype=jnp.float32, with_flow=False,
                            with_mask=False, head_grid=head_grid)
    init_hw = head_grid and (head_grid[0] * 64, head_grid[1] * 64) or input_size
    var = mj.init(jax.random.PRNGKey(0), jnp.zeros((1, *init_hw, 6)))
    params = randomize_heads(jax.tree.map(np.asarray, var["params"]))
    mt = fn_t.DeepIMFlowNet(num_classes=C, head_grid=head_grid,
                            input_size=input_size, dtype=dtype)
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
    # Decoder subtrees are skipped; unknown ones are refused.
    with_decoder = dict(var["params"], deconv5={"kernel": np.zeros(1)},
                        mask_pred={"kernel": np.zeros(1)})
    assert flax_to_torch(with_decoder).keys() == sd.keys()
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
    with pytest.raises(NotImplementedError):
        fn_t.DeepIMFlowNet(input_size=(64, 64), quant="int8")
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
