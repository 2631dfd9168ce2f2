"""FlowNetS-backbone DeepIM network with its flow and mask heads (torch).

Port of ``deepim_tpu/models/flownet.py``: ``DeepIMFlowNet`` with the
encoder conv1 .. conv6_1, the FlowNetS decoder (``predict_flow6..2``,
``deconv5..2``, ``upsample_flow{l+1}to{l}``, ``_crop_to``) and the mask
head (``mask_conv``, ``mask_pred``) that training supervises, the flatten
pose head with the ``head_grid`` resize or the ``gap`` head, fc1/fc2, the
float32 fc_rot/fc_trans heads and ``trans_scale``; plus
``bottleneck_grid``, ``select_class``, ``decode_rot``, ``network_input``
and ``normalize_depth``.  The space-to-depth stem and the fast
deconvolution (TPU layouts of the same parameters, off by default in the
reference) and int8 are not ported.

Numbers follow the reference's flax modules:

- Padding is XLA's SAME, which splits odd padding with the extra pixel at
  the end and depends on the live input size (:func:`same_pad`);
  ``Conv2d(padding=k//2)`` would shift stride-2 taps by one pixel.
  ``mxnet_pad=True`` pads the encoder convs ``k//2`` on both sides instead,
  as MXNet does (the reference's ``Conv(sym_pad=True)``): weights converted
  from the MXNet DeepIM (``train/convert_mxnet.py``) need it.  It differs
  from SAME only in the stride-2 convs conv1 .. conv6.
- The decoder's 4x4/s2 transposed convs: flax's ``ConvTranspose`` with
  SAME pads the stride-dilated input by (2, 2) and correlates with its
  kernel unflipped; torch's ``conv_transpose2d`` is a conv's gradient,
  so it flips the kernel, and ``padding=1`` gives the same (2, 2) and an
  output of exactly 2n.  The bridge flips the kernels.
- ``dtype`` is the compute type of the convs, the decoder and fc1/fc2
  (params stay float32 and are cast per call, like flax ``dtype=bf16,
  param_dtype=f32``); fc_rot/fc_trans always run in float32, and the flow
  and mask outputs are returned in float32.
- The flatten is NHWC-ordered, so fc1 weights carry over unpermuted.
- Initial weights follow flax's defaults (truncated lecun-normal kernels,
  zero biases, identity pose heads), drawn from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepim_tpu_torch.geometry.rotations import euler2quat, quat_normalize

# Flax's lecun_normal draws a normal truncated at 2 std, rescaled by this
# factor so the variance stays 1 / fan_in.
_TRUNC_STD = 0.87962566103423978

# (name, out channels, kernel, stride) of the encoder, input to bottleneck.
ENCODER = (
    ("conv1", 64, 7, 2), ("conv2", 128, 5, 2), ("conv3", 256, 5, 2),
    ("conv3_1", 256, 3, 1), ("conv4", 512, 3, 2), ("conv4_1", 512, 3, 1),
    ("conv5", 512, 3, 2), ("conv5_1", 512, 3, 1), ("conv6", 1024, 3, 2),
    ("conv6_1", 1024, 3, 1),
)
# Encoder output feeding each decoder level (the skip), and the decoder's
# (level, deconv channels) from the bottleneck up.  Level l predicts flow
# at 1/2^l of the input.
SKIPS = {5: "conv5_1", 4: "conv4_1", 3: "conv3_1", 2: "conv2"}
DECODER = ((5, 512), (4, 256), (3, 128), (2, 64))
FLOW_LEVELS = (6, 5, 4, 3, 2)


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA SAME padding (lo, hi) of one spatial dim of size ``n``."""
    pad = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def bottleneck_grid(input_height: int, input_width: int) -> tuple[int, int]:
    """Spatial dims of conv6_1 for a given input (six SAME stride-2 convs)."""
    return (-(-input_height // 64), -(-input_width // 64))


def _fan_in(module: nn.Module, p: torch.Tensor) -> int:
    """flax's fan-in of a kernel: a transposed conv's weight is (in, out,
    kh, kw) in torch, every other weight has its fan-in in ``p[0]``."""
    if isinstance(module, nn.ConvTranspose2d):
        return p.shape[0] * p.shape[2] * p.shape[3]
    return p[0].numel()


class DeepIMFlowNet(nn.Module):
    """The DeepIM network.

    ``forward(x, pose_only=False)`` takes the (B, H, W, C) NHWC input of
    :func:`network_input` (the reference's layout) and returns
    ``{"rot_raw": (B, num_classes, rot_dim), "trans": (B, num_classes, 3)}``,
    plus, unless ``pose_only``, ``"flow"`` {level: (B, H/2^l, W/2^l, 2)}
    when ``with_flow`` and ``"mask_logit"`` (B, H/4, W/4, 1) when
    ``with_mask``, both float32.  The decoder exists (and has parameters)
    when either head is on; the refine loop and the service run the
    pose-only forward, so their models are built without it.

    ``pose_head="flatten"`` (the reference's) fixes fc1's width at
    construction: ``head_grid`` (bottleneck grid every input is resized
    to, required for coarse-to-fine) or, without it, the bottleneck of
    ``input_size``; ``"gap"`` averages the bottleneck over space.
    Initial weights are drawn from ``generator`` (a fresh generator seeded
    0 when None), the decoder's after the pose head's, so a model with and
    one without the decoder share every other initial weight.
    """

    def __init__(self, num_classes: int = 1, rot_type: str = "quat",
                 head_grid: tuple[int, int] | None = None,
                 input_size: tuple[int, int] | None = None,
                 input_mask: bool = False, input_depth: bool = False,
                 fc_dim: int = 1024,
                 trans_scale: tuple[float, float, float] = (20.0, 20.0, 0.5),
                 dtype: torch.dtype = torch.bfloat16, quant: str = "none",
                 with_flow: bool = False, with_mask: bool = False,
                 pose_head: str = "flatten", mxnet_pad: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if quant != "none":
            raise NotImplementedError(
                f"quant={quant!r}: int8 inference is not ported yet "
                "(ROADMAP A10)")
        if rot_type not in ("quat", "euler"):
            raise ValueError(rot_type)
        if pose_head not in ("flatten", "gap"):
            raise ValueError(pose_head)
        if pose_head == "flatten" and head_grid is None and input_size is None:
            raise ValueError("give head_grid or input_size: fc1's width "
                             "depends on the bottleneck grid")
        self.num_classes = num_classes
        self.rot_type = rot_type
        self.rot_dim = 4 if rot_type == "quat" else 3
        self.head_grid = None if head_grid is None else tuple(head_grid)
        self.input_mask = input_mask
        self.input_depth = input_depth
        self.with_flow = with_flow
        self.with_mask = with_mask
        self.pose_head = pose_head
        self.mxnet_pad = mxnet_pad
        self.dtype = dtype
        self.register_buffer("trans_scale",
                             torch.tensor(trans_scale, dtype=torch.float32),
                             persistent=False)
        cin = 6 + 2 * input_mask + 2 * input_depth
        skip_init = torch.nn.utils.skip_init  # weights are drawn below
        channels = {}
        for name, cout, k, s in ENCODER:
            self.add_module(name, skip_init(nn.Conv2d, cin, cout, k, stride=s))
            cin = channels[name] = cout
        if pose_head == "flatten":
            gh, gw = self.head_grid or bottleneck_grid(*input_size)
            self.fc1 = skip_init(nn.Linear, cin * gh * gw, fc_dim)
        else:
            self.fc1 = skip_init(nn.Linear, cin, fc_dim)
        self.fc2 = skip_init(nn.Linear, fc_dim, fc_dim)
        self.fc_rot = skip_init(nn.Linear, fc_dim, num_classes * self.rot_dim)
        self.fc_trans = skip_init(nn.Linear, fc_dim, num_classes * 3)
        if with_flow or with_mask:
            self.predict_flow6 = skip_init(nn.Conv2d, cin, 2, 3)
            for lvl, cout in DECODER:
                self.add_module(f"deconv{lvl}", skip_init(
                    nn.ConvTranspose2d, cin, cout, 4, stride=2, padding=1))
                self.add_module(f"upsample_flow{lvl + 1}to{lvl}", skip_init(
                    nn.ConvTranspose2d, 2, 2, 4, stride=2, padding=1))
                cin = channels[SKIPS[lvl]] + cout + 2
                self.add_module(f"predict_flow{lvl}", skip_init(nn.Conv2d, cin, 2, 3))
            if with_mask:
                self.mask_conv = skip_init(nn.Conv2d, cin, 64, 3)
                self.mask_pred = skip_init(nn.Conv2d, 64, 1, 3)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod_name, mod in self.named_children():
                for p_name, p in mod.named_parameters():
                    if p_name == "bias" or mod_name in ("fc_rot", "fc_trans"):
                        p.zero_()
                    else:
                        std = (1.0 / _fan_in(mod, p)) ** 0.5 / _TRUNC_STD
                        nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                              generator=g)
            # Identity heads, as the reference initialises them: an
            # untrained net leaves every pose unchanged.
            if rot_type == "quat":
                self.fc_rot.bias.view(num_classes, 4)[:, 0] = 1.0

    def _same(self, conv: nn.Conv2d, x: torch.Tensor, sym: bool = False) -> torch.Tensor:
        """``conv`` with XLA SAME padding, or ``k//2`` on both sides when
        ``sym`` (MXNet's), in the compute type."""
        k, s = conv.kernel_size[0], conv.stride[0]
        if sym:
            (ht, hb) = (wl, wr) = (k // 2, k // 2)
        else:
            (ht, hb), (wl, wr) = (same_pad(x.shape[2], k, s),
                                  same_pad(x.shape[3], k, s))
        x = F.pad(x, (wl, wr, ht, hb))
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype), s)

    def _conv(self, name: str, x: torch.Tensor, sym: bool = False) -> torch.Tensor:
        return leaky(self._same(getattr(self, name), x, sym))

    def _up(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A 4x4/s2 transposed conv with flax's SAME (output 2n)."""
        conv = getattr(self, name)
        return F.conv_transpose2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                  stride=2, padding=1)

    @staticmethod
    def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))

    def _decode(self, c6: torch.Tensor, skips: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        """The FlowNetS refinement stack and the mask head, off the finest
        decoder features (1/4 scale)."""
        feat = c6
        flow = self._same(self.predict_flow6, feat)
        flows = {6: flow}
        for lvl, _ in DECODER:
            skip = skips[SKIPS[lvl]]
            h, w = skip.shape[2:]
            # SAME on a transposed conv can overshoot an odd skip by one
            # pixel (the reference's _crop_to).
            up_feat = leaky(self._up(f"deconv{lvl}", feat))[..., :h, :w]
            up_flow = self._up(f"upsample_flow{lvl + 1}to{lvl}", flow)[..., :h, :w]
            feat = torch.cat([skip, up_feat, up_flow], dim=1)
            flow = flows[lvl] = self._same(getattr(self, f"predict_flow{lvl}"), feat)
        out = {}
        if self.with_flow:
            out["flow"] = {lvl: f.permute(0, 2, 3, 1).float() for lvl, f in flows.items()}
        if self.with_mask:
            m = self._same(self.mask_pred, self._conv("mask_conv", feat))
            out["mask_logit"] = m.permute(0, 2, 3, 1).float()
        return out

    def forward(self, x: torch.Tensor, pose_only: bool = False) -> dict[str, torch.Tensor]:
        decode = (self.with_flow or self.with_mask) and not pose_only
        c = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        skips = {}
        for name, *_ in ENCODER:
            c = self._conv(name, c, self.mxnet_pad)
            if decode and name in SKIPS.values():
                skips[name] = c
        out = self._decode(c, skips) if decode else {}
        if self.pose_head == "gap":
            h = c.mean(dim=(2, 3))
        else:
            if self.head_grid is not None and tuple(c.shape[2:]) != self.head_grid:
                c = F.interpolate(c, size=self.head_grid, mode="bilinear",
                                  align_corners=False, antialias=False)
            h = c.permute(0, 2, 3, 1).reshape(c.shape[0], -1)  # NHWC flatten
        h = leaky(self._linear(self.fc1, h))
        h = leaky(self._linear(self.fc2, h)).float()
        rot = self._linear(self.fc_rot, h)
        trans = self._linear(self.fc_trans, h)
        out["rot_raw"] = rot.reshape(-1, self.num_classes, self.rot_dim)
        out["trans"] = trans.reshape(-1, self.num_classes, 3) * self.trans_scale
        return out


def select_class(per_class: torch.Tensor, class_idx: torch.Tensor) -> torch.Tensor:
    """(B, num_classes, D), (B,) int -> (B, D); a one-class model shares its
    head across all classes (index clamps to 0)."""
    idx = class_idx.long().clamp_max(per_class.shape[1] - 1)
    return per_class[torch.arange(per_class.shape[0], device=per_class.device), idx]


def decode_rot(rot_raw: torch.Tensor, rot_type: str) -> torch.Tensor:
    """Raw rotation head output (B, rot_dim) -> unit quaternion (B, 4)."""
    if rot_type == "quat":
        return quat_normalize(rot_raw)
    if rot_type == "euler":
        return euler2quat(rot_raw[..., 0], rot_raw[..., 1], rot_raw[..., 2])
    raise ValueError(rot_type)


def normalize_depth(depth: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(B, H, W) metric depth -> (B, H, W, 1) channel ``d / z - 1`` (0 on
    background), normalised by the current estimate's object z."""
    zref = z.clamp_min(1e-6)[:, None, None]
    return torch.where(depth > 0, depth / zref - 1.0, 0.0)[..., None]


def network_input(obs_rgb: torch.Tensor, ren_rgb: torch.Tensor,
                  extras: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Assemble the (B, H, W, 6+) network input from the two [0, 1] crops,
    centred to [-0.5, 0.5]."""
    return torch.cat([obs_rgb - 0.5, ren_rgb - 0.5, *extras], dim=-1)
