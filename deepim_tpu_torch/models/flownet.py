"""FlowNetS-backbone DeepIM network, pose-only forward (torch).

Port of ``deepim_tpu/models/flownet.py``: ``DeepIMFlowNet`` as the refine
loop runs it (``pose_only=True``): the encoder conv1 .. conv6_1, the
flatten pose head with the ``head_grid`` resize, fc1/fc2, the float32
fc_rot/fc_trans heads and ``trans_scale``; plus ``bottleneck_grid``,
``select_class``, ``decode_rot``, ``network_input`` and
``normalize_depth``.  The flow decoder, the mask head, the space-to-depth
stem, the fast deconvolution and int8 are not ported yet.

Numbers follow the reference's flax modules:

- Padding is XLA's SAME, which splits odd padding with the extra pixel at
  the end and depends on the live input size (:func:`same_pad`);
  ``Conv2d(padding=k//2)`` would shift stride-2 taps by one pixel.
- ``dtype`` is the compute type of the convs and fc1/fc2 (params stay
  float32 and are cast per call, like flax ``dtype=bf16,
  param_dtype=f32``); fc_rot/fc_trans always run in float32.
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


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA SAME padding (lo, hi) of one spatial dim of size ``n``."""
    pad = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def bottleneck_grid(input_height: int, input_width: int) -> tuple[int, int]:
    """Spatial dims of conv6_1 for a given input (six SAME stride-2 convs)."""
    return (-(-input_height // 64), -(-input_width // 64))


class DeepIMFlowNet(nn.Module):
    """Pose-only DeepIM network.

    ``forward(x)`` takes the (B, H, W, C) NHWC input of
    :func:`network_input` (the reference's layout) and returns
    ``{"rot_raw": (B, num_classes, rot_dim), "trans": (B, num_classes, 3)}``.

    fc1's width is fixed at construction: ``head_grid`` (bottleneck grid
    every input is resized to, required for coarse-to-fine) or, without
    it, the bottleneck of ``input_size``.  Initial weights are drawn from
    ``generator`` (a fresh generator seeded 0 when None).
    """

    def __init__(self, num_classes: int = 1, rot_type: str = "quat",
                 head_grid: tuple[int, int] | None = None,
                 input_size: tuple[int, int] | None = None,
                 input_mask: bool = False, input_depth: bool = False,
                 fc_dim: int = 1024,
                 trans_scale: tuple[float, float, float] = (20.0, 20.0, 0.5),
                 dtype: torch.dtype = torch.bfloat16, quant: str = "none",
                 generator: torch.Generator | None = None):
        super().__init__()
        if quant != "none":
            raise NotImplementedError(
                f"quant={quant!r}: int8 inference is not ported yet "
                "(ROADMAP A10)")
        if rot_type not in ("quat", "euler"):
            raise ValueError(rot_type)
        if head_grid is None and input_size is None:
            raise ValueError("give head_grid or input_size: fc1's width "
                             "depends on the bottleneck grid")
        self.num_classes = num_classes
        self.rot_type = rot_type
        self.rot_dim = 4 if rot_type == "quat" else 3
        self.head_grid = None if head_grid is None else tuple(head_grid)
        self.input_mask = input_mask
        self.input_depth = input_depth
        self.dtype = dtype
        self.register_buffer("trans_scale",
                             torch.tensor(trans_scale, dtype=torch.float32),
                             persistent=False)
        cin = 6 + 2 * input_mask + 2 * input_depth
        skip_init = torch.nn.utils.skip_init  # weights are drawn below
        for name, cout, k, s in ENCODER:
            self.add_module(name, skip_init(nn.Conv2d, cin, cout, k, stride=s))
            cin = cout
        gh, gw = self.head_grid or bottleneck_grid(*input_size)
        self.fc1 = skip_init(nn.Linear, cin * gh * gw, fc_dim)
        self.fc2 = skip_init(nn.Linear, fc_dim, fc_dim)
        self.fc_rot = skip_init(nn.Linear, fc_dim, num_classes * self.rot_dim)
        self.fc_trans = skip_init(nn.Linear, fc_dim, num_classes * 3)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias") or name.startswith(("fc_rot", "fc_trans")):
                    p.zero_()
                else:
                    std = (1.0 / p[0].numel()) ** 0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=g)
            # Identity heads, as the reference initialises them: an
            # untrained net leaves every pose unchanged.
            if rot_type == "quat":
                self.fc_rot.bias.view(num_classes, 4)[:, 0] = 1.0

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, name)
        k, s = conv.kernel_size[0], conv.stride[0]
        (ht, hb), (wl, wr) = (same_pad(x.shape[2], k, s),
                              same_pad(x.shape[3], k, s))
        x = F.pad(x, (wl, wr, ht, hb))
        y = F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype), s)
        return leaky(y)

    @staticmethod
    def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        c = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for name, *_ in ENCODER:
            c = self._conv(name, c)
        if self.head_grid is not None and tuple(c.shape[2:]) != self.head_grid:
            c = F.interpolate(c, size=self.head_grid, mode="bilinear",
                              align_corners=False, antialias=False)
        h = c.permute(0, 2, 3, 1).reshape(c.shape[0], -1)  # NHWC flatten
        h = leaky(self._linear(self.fc1, h))
        h = leaky(self._linear(self.fc2, h)).float()
        rot = self._linear(self.fc_rot, h)
        trans = self._linear(self.fc_trans, h)
        return {
            "rot_raw": rot.reshape(-1, self.num_classes, self.rot_dim),
            "trans": trans.reshape(-1, self.num_classes, 3) * self.trans_scale,
        }


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
