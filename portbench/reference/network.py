"""The DeepIM network (FlowNetSimple encoder, its flow decoder and mask
head, the flatten pose head), written out as plain float32 functions.

Li et al., "DeepIM: Deep Iterative Matching for 6D Pose Estimation",
ECCV 2018, §3-4, on FlowNetSimple (Dosovitskiy et al., ICCV 2015): the
observed and the rendered crop, each centred to [-0.5, 0.5], are stacked
into six channels; ten convolutions (7x7/2 to 3x3) with LeakyReLU(0.1)
make the bottleneck; a flow decoder of 4x4/2 transposed convolutions with
skips predicts flow at 1/64 .. 1/4 and a mask head a foreground logit at
1/4; the bottleneck, resized bilinearly to the full-size grid and
flattened channels last, feeds fc1 and fc2 (LeakyReLU) and per-class
quaternion and translation heads (the translation scaled by (20, 20,
0.5)).

The parameters are a dict named as the program names them, so one dict
drawn by the benchmark serves both sides.  Padding is "SAME" with the odd
pixel at the end; a transposed convolution is ``conv_transpose2d``
with padding 1 (output exactly twice the input).

``quant`` computes one precision below the configuration's bfloat16, the
control of ``correct``: every convolution, transposed convolution and
dense layer takes its operands rounded (a scale per sample for
activations, per output channel for weights), and in the backward the
gradient arriving at its output is rounded too (a scale per sample), so
both products of the backward see rounded operands; the rounding of the
forward passes the gradient straight through.  ``"int8"`` rounds to
symmetric int8 both ways; ``"fp8"`` to float8 e4m3 in the forward and
e5m2 in the backward, the usual recipe of fp8 training.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ENCODER = (("conv1", 64, 7, 2), ("conv2", 128, 5, 2), ("conv3", 256, 5, 2),
           ("conv3_1", 256, 3, 1), ("conv4", 512, 3, 2), ("conv4_1", 512, 3, 1),
           ("conv5", 512, 3, 2), ("conv5_1", 512, 3, 1), ("conv6", 1024, 3, 2),
           ("conv6_1", 1024, 3, 1))
SKIPS = {5: "conv5_1", 4: "conv4_1", 3: "conv3_1", 2: "conv2"}
DECODER = ((5, 512), (4, 256), (3, 128), (2, 64))
TRANS_SCALE = (20.0, 20.0, 0.5)


def grid(h, w):
    return -(-h // 64), -(-w // 64)


def param_shapes(num_classes: int, size, decoder: bool, mask: bool, fc_dim: int = 1024,
                 cin: int = 6) -> dict:
    """name -> (shape, fan_in) for a network whose heads see ``size``."""
    out, ch = {}, {}
    for name, cout, k, _ in ENCODER:
        out[f"{name}.weight"] = ((cout, cin, k, k), cin * k * k)
        out[f"{name}.bias"] = ((cout,), 0)
        cin = ch[name] = cout
    gh, gw = grid(*size)
    out["fc1.weight"], out["fc1.bias"] = ((fc_dim, cin * gh * gw), cin * gh * gw), ((fc_dim,), 0)
    out["fc2.weight"], out["fc2.bias"] = ((fc_dim, fc_dim), fc_dim), ((fc_dim,), 0)
    out["fc_rot.weight"] = ((4 * num_classes, fc_dim), fc_dim)
    out["fc_rot.bias"] = ((4 * num_classes,), 0)
    out["fc_trans.weight"] = ((3 * num_classes, fc_dim), fc_dim)
    out["fc_trans.bias"] = ((3 * num_classes,), 0)
    if decoder:
        out["predict_flow6.weight"] = ((2, cin, 3, 3), cin * 9)
        out["predict_flow6.bias"] = ((2,), 0)
        for lvl, cout in DECODER:
            out[f"deconv{lvl}.weight"] = ((cin, cout, 4, 4), cin * 16)
            out[f"deconv{lvl}.bias"] = ((cout,), 0)
            out[f"upsample_flow{lvl + 1}to{lvl}.weight"] = ((2, 2, 4, 4), 32)
            out[f"upsample_flow{lvl + 1}to{lvl}.bias"] = ((2,), 0)
            cin = ch[SKIPS[lvl]] + cout + 2
            out[f"predict_flow{lvl}.weight"] = ((2, cin, 3, 3), cin * 9)
            out[f"predict_flow{lvl}.bias"] = ((2,), 0)
        if mask:
            out["mask_conv.weight"], out["mask_conv.bias"] = ((64, cin, 3, 3), cin * 9), ((64,), 0)
            out["mask_pred.weight"], out["mask_pred.bias"] = ((1, 64, 3, 3), 576), ((1,), 0)
    return out


def rounded(x, dims, fmt: str):
    """``x`` rounded to ``fmt`` (int8, e4m3 or e5m2) with a symmetric scale
    over ``dims`` that maps its largest magnitude to the format's largest
    value; the values stay float32."""
    top = {"int8": 127.0, "e4m3": 448.0, "e5m2": 57344.0}[fmt]
    scale = x.detach().abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / top
    if fmt == "int8":
        return torch.round(x / scale).clamp(-top, top) * scale
    dtype = torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2
    return (x / scale).clamp(-top, top).to(dtype).to(x.dtype) * scale


FORWARD = {"int8": "int8", "fp8": "e4m3"}
BACKWARD = {"int8": "int8", "fp8": "e5m2"}


class _Round(torch.autograd.Function):
    """Rounding in the forward, the gradient straight through."""

    @staticmethod
    def forward(ctx, x, dims, quant):
        return rounded(x, dims, FORWARD[quant])

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _RoundGrad(torch.autograd.Function):
    """The identity in the forward, the gradient rounded per sample."""

    @staticmethod
    def forward(ctx, y, quant):
        ctx.quant = quant
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, tuple(range(1, g.dim())), BACKWARD[ctx.quant]), None


def _q(x, dims, quant):
    return _Round.apply(x, dims, quant) if quant else x


def _grad_q(y, quant):
    return _RoundGrad.apply(y, quant) if quant else y


def _same(n, k, s):
    pad = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def conv(p, name, x, stride=1, quant=None):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    k = w.shape[-1]
    (t, bo), (l, r) = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
    x = F.pad(x, (l, r, t, bo))
    return _grad_q(F.conv2d(_q(x, (1, 2, 3), quant), _q(w, (1, 2, 3), quant), b, stride), quant)


def linear(p, name, h, quant=None):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    return _grad_q(F.linear(_q(h, (1,), quant), _q(w, (1,), quant), b), quant)


def leaky(x):
    return F.leaky_relu(x, 0.1)


def forward(p: dict, x: torch.Tensor, head_grid, pose_only: bool = True,
            decoder: bool = False, mask: bool = False, quant=None) -> dict:
    """``x`` (B, H, W, C) -> {"rot_raw" (B, classes, 4), "trans" (B, classes, 3)},
    with {"flow": {level: (B, h, w, 2)}, "mask_logit": (B, h, w, 1)}
    unless ``pose_only``."""
    c = x.permute(0, 3, 1, 2)
    skips = {}
    for name, _, _, s in ENCODER:
        c = leaky(conv(p, name, c, s, quant))
        skips[name] = c
    out = {}
    if decoder and not pose_only:
        feat = c
        flow = conv(p, "predict_flow6", feat, quant=quant)
        flows = {6: flow}
        for lvl, _ in DECODER:
            skip = skips[SKIPS[lvl]]
            h, w = skip.shape[2:]

            def up(name, t):
                y = F.conv_transpose2d(_q(t, (1, 2, 3), quant),
                                       _q(p[f"{name}.weight"], (0, 2, 3), quant),
                                       p[f"{name}.bias"], stride=2, padding=1)
                return _grad_q(y, quant)[..., :h, :w]

            feat = torch.cat([skip, leaky(up(f"deconv{lvl}", feat)),
                              up(f"upsample_flow{lvl + 1}to{lvl}", flow)], 1)
            flow = flows[lvl] = conv(p, f"predict_flow{lvl}", feat, quant=quant)
        out["flow"] = {lvl: f.permute(0, 2, 3, 1) for lvl, f in flows.items()}
        if mask:
            m = conv(p, "mask_pred", leaky(conv(p, "mask_conv", feat, quant=quant)), quant=quant)
            out["mask_logit"] = m.permute(0, 2, 3, 1)
    if tuple(c.shape[2:]) != tuple(head_grid):
        c = F.interpolate(c, size=tuple(head_grid), mode="bilinear", align_corners=False)
    h = c.permute(0, 2, 3, 1).reshape(c.shape[0], -1)
    h = leaky(linear(p, "fc2", leaky(linear(p, "fc1", h, quant)), quant))
    b = x.shape[0]
    out["rot_raw"] = linear(p, "fc_rot", h, quant).reshape(b, -1, 4)
    scale = torch.tensor(TRANS_SCALE, device=x.device)
    out["trans"] = linear(p, "fc_trans", h, quant).reshape(b, -1, 3) * scale
    return out
