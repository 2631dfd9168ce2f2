"""FlowNetS-backbone DeepIM network with its flow and mask heads (torch).

Port of ``deepim_tpu/models/flownet.py``: ``DeepIMFlowNet`` with the
encoder conv1 .. conv6_1, the FlowNetS decoder (``predict_flow6..2``,
``deconv5..2``, ``upsample_flow{l+1}to{l}``, ``_crop_to``) and the mask
head (``mask_conv``, ``mask_pred``) that training supervises, the flatten
pose head with the ``head_grid`` resize or the ``gap`` head, fc1/fc2, the
float32 fc_rot/fc_trans heads and ``trans_scale``; plus
``bottleneck_grid``, ``select_class``, ``decode_rot``, ``network_input``
and ``normalize_depth``; and int8 inference (``quant="int8"``): the
quantize helpers, :func:`int8_conv` and :func:`int8_linear` for the
encoder and fc1/fc2, dynamic or calibrated static activation scales
(``act_scales``, see ``models/quant.py``) and the calibration recorder.
conv1 always runs as the reference's space-to-depth stem (``StemConv``,
off by default there), its input channels padded to 8 (``_conv1``); the
fast deconvolution (a TPU layout of the same parameters, off by default in
the reference) is not ported.

int8 follows the reference's ``Conv``/``QDense`` int8 branches number for
number: symmetric scales (zero point 0), activations per sample or
static, weights per output channel, per-channel static scales folded into
the float weight before it is quantized, and the products int8 x int8 ->
int32 (exact while ``K * 127**2 < 2**31``), here ``torch._int_mm`` on a
patch matrix built from strided views of the int8 activations (cuBLASLt
on the card).  The int8 encoder runs NHWC, the reference's layout, so the
patches and the flatten need no permute.  A conv's output is
``leaky((y + bias).to(dtype))`` and an FC's ``leaky(y + bias).to(dtype)``
(float32 leaky), as in the reference.

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

import contextlib
import copy
import math
from typing import Sequence

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from deepim_tpu_torch.geometry.rotations import euler2quat, quat_normalize
from deepim_tpu_torch.utils.profiling import stage

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
#: conv1's input channels are rounded up to a multiple of this (8 bf16
#: values, 16 bytes) before its space-to-depth fold (``_conv1``).
CONV1_CHANNELS = 8


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


# -- int8 inference ------------------------------------------------------------

#: Bytes of int8 patch matrix built at a time: a conv's batch is cut into
#: chunks under this (conv1 at B=128, 480x640 would need 2.9 GB at once).
PATCH_BYTES = 1 << 30
#: The fewest rows of the first operand and the multiple of the depth and
#: of the width that ``torch._int_mm`` takes on the card (its checks: rows
#: > 16, depth and width multiples of 8); operands are zero-padded to them
#: on every device, which leaves the int32 sums exact.
INT_MM_MIN_ROWS, INT_MM_MULTIPLE = 17, 8
#: The statistics the calibration recorder keeps per quantized layer.
CALIB_STATS = ("amax", "amax_c", "p999", "p999_c")


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def quantize_int8(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization -> (int8 values, float32 scale).

    ``dims`` are reduced for the max-abs scale ``max(amax, 1e-12) / 127``
    (kept as size-1 dims so the scale broadcasts back); values are
    ``round(x / scale)`` (half to even) clipped to +-127, so zero stays 0.
    Divisions are by device tensors: CUDA's division by a Python scalar
    multiplies by its reciprocal and would flip roundings against the CPU.
    """
    # |x| and its max are exact in x's own type; x / scale promotes to
    # float32 (scale keeps x's rank), so no float32 copy of x is made.
    amax = x.abs().amax(dim=dims, keepdim=True).float()
    scale = amax.clamp_min(1e-12) / _f32(127.0, x.device)
    q = torch.round(x / scale).clamp_(-127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_int8_static(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization with a fixed (calibrated) ``scale``: a
    float, or a tuple of per-channel floats broadcast over the trailing
    (channel) axis, as in the reference's NHWC, or either as a float32
    tensor.  Values beyond the calibrated range saturate at +-127."""
    s = _f32(scale, x.device)
    return torch.round(x.float() / s).clamp_(-127.0, 127.0).to(torch.int8)


def _check_depth(k_depth: int, what: str) -> None:
    if k_depth * 127 * 127 >= 2 ** 31:
        raise ValueError(f"int8 {what} contraction depth {k_depth} could overflow int32")


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` of int8 ``a`` (M, K) and int8 ``w`` (N, K') -> int32
    (M, N), exact, by ``torch._int_mm``.  The operands are zero-padded to
    the card's shapes (rows, and the depth ``max(K, K')`` and N to
    multiples of 8) and the padding dropped from the result; a patch
    matrix comes with its depth padded already, so the big operand is
    never copied."""
    m, n = a.shape[0], w.shape[0]
    kp = _ceil_to(max(a.shape[1], w.shape[1]), INT_MM_MULTIPLE)
    if m < INT_MM_MIN_ROWS or a.shape[1] != kp:
        a = F.pad(a, (0, kp - a.shape[1], 0, max(INT_MM_MIN_ROWS - m, 0)))
    np_ = _ceil_to(n, INT_MM_MULTIPLE)
    if w.shape != (np_, kp):
        w = F.pad(w, (0, kp - w.shape[1], 0, np_ - n))
    y = torch._int_mm(a, w.t())  # w row-major (N, K): mat2 column-major, cuBLASLt's layout
    return y[:m, :n]


def im2col_int8(xq: torch.Tensor, k: int, stride: int, pads: tuple[int, int, int, int]
                ) -> torch.Tensor:
    """The patch matrix of an int8 NHWC tensor for a ``k`` x ``k`` conv:
    (B * Ho * Wo, K') int8, rows in (b, i, j) order and the K = k * k * C
    columns in (dy, dx, c) order (the HWIO weight's flattening),
    zero-padded to K', a multiple of 8.  Built from ``Tensor.unfold``
    views (``F.unfold`` has no int8 kernel)."""
    top, bottom, left, right = pads
    xp = F.pad(xq, (0, 0, left, right, top, bottom))
    win = xp.unfold(1, k, stride).unfold(2, k, stride)  # (B, Ho, Wo, C, k, k)
    b, ho, wo, c = win.shape[:4]
    kd = k * k * c
    out = torch.empty((b * ho * wo, _ceil_to(kd, INT_MM_MULTIPLE)), dtype=torch.int8,
                      device=xq.device)
    out[:, :kd].view(b, ho, wo, k, k, c).copy_(win.permute(0, 1, 2, 4, 5, 3))
    out[:, kd:].zero_()
    return out


def conv_int32(xq: torch.Tensor, wq: torch.Tensor, stride: int,
               pads: tuple[int, int, int, int]) -> torch.Tensor:
    """The exact int32 conv of int8 NHWC ``xq`` with int8 OIHW ``wq`` ->
    (B, Ho, Wo, O) int32, over batch chunks of at most :data:`PATCH_BYTES`
    of patches each."""
    o, c, k, _ = wq.shape
    w_rows = wq.permute(0, 2, 3, 1).reshape(o, k * k * c)  # (O, K) in (dy, dx, c) order
    b, h, w = xq.shape[:3]
    top, bottom, left, right = pads
    ho = (h + top + bottom - k) // stride + 1
    wo = (w + left + right - k) // stride + 1
    per_sample = ho * wo * _ceil_to(k * k * c, INT_MM_MULTIPLE)
    chunk = max(1, PATCH_BYTES // max(per_sample, 1))
    out = torch.empty((b, ho, wo, o), dtype=torch.int32, device=xq.device)
    for b0 in range(0, b, chunk):
        part = xq[b0:b0 + chunk]
        out[b0:b0 + part.shape[0]] = int_mm(im2col_int8(part, k, stride, pads),
                                            w_rows).view(part.shape[0], ho, wo, o)
    return out


def _quantize_activations(x: torch.Tensor, act_scale, dims):
    """-> (int8 ``x``, its scale or None, per-channel scales to fold into
    the weight or None): dynamic over ``dims``, or static."""
    if act_scale is None:
        xq, sx = quantize_int8(x, dims)
        return xq, sx, None
    s = _f32(act_scale, x.device)
    return quantize_int8_static(x, s), (None if s.ndim else s), (s if s.ndim else None)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: int,
              pads: tuple[int, int, int, int], act_scale=None) -> torch.Tensor:
    """NHWC conv with both operands int8-quantized on the fly -> float32
    NHWC (the reference's ``_int8_conv``; ``weight`` OIHW float32, ``pads``
    (top, bottom, left, right)).

    Activations: dynamic per-sample scales (dims 1-3), or the calibrated
    static ``act_scale`` (a float, a per-input-channel tuple, or either as
    a float32 tensor); per-channel scales fold into the float weight
    (``W * s_c`` on OIHW dim 1) before it is quantized, so the activation
    scale becomes 1.  Weights: per output channel.  The int32 products
    are exact, so the only error is the two roundings; the result is
    ``y * sx * sk`` in that order.
    """
    o, c, k, _ = weight.shape
    _check_depth(k * k * c, "conv")
    xq, sx, fold = _quantize_activations(x, act_scale, (1, 2, 3))
    if fold is not None:
        weight = weight * fold.reshape(1, -1, 1, 1)
    wq, sk = quantize_int8(weight, (1, 2, 3))
    y = conv_int32(xq, wq, stride, pads).float()
    if sx is not None:
        y = y * sx
    return y * sk.reshape(o)


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                act_scale=None) -> torch.Tensor:
    """int8 ``x @ weight.T + bias`` -> float32 (the reference's ``QDense``;
    ``weight`` (out, in) float32): per-sample or static activation scales
    (a per-feature tuple folds into the weight's columns), per-output
    weight scales, ``y * sx * sk + bias``."""
    _check_depth(x.shape[-1], "dense")
    xq, sx, fold = _quantize_activations(x, act_scale, (1,))
    if fold is not None:
        weight = weight * fold[None, :]
    wq, sk = quantize_int8(weight, (1,))
    y = int_mm(xq, wq).float()
    if sx is not None:
        y = y * sx
    return y * sk.reshape(1, -1) + bias


def _percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q, axis=-1)`` (linear interpolation, its float32
    index arithmetic) by ``torch.kthvalue``: ``torch.quantile`` refuses
    more than 2**24 elements."""
    n = a.shape[-1]
    f32 = np.float32
    pos = f32(f32(q) / f32(100.0)) * (f32(n) - f32(1.0))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = f32(pos - lo)
    w_lo = f32(1.0) - w_hi
    lo_v = torch.kthvalue(a, int(min(max(lo, 0), n - 1)) + 1, dim=-1).values
    hi_v = torch.kthvalue(a, int(min(max(hi, 0), n - 1)) + 1, dim=-1).values
    return lo_v * _f32(w_lo, a.device) + hi_v * _f32(w_hi, a.device)


def layer_stats(x: torch.Tensor, keys) -> dict[str, torch.Tensor]:
    """The calibration statistics ``keys`` of one quantized layer's input
    (channels last): max |x| and its 99.9th percentile, over all of it
    (``amax``, ``p999``) and per channel (``amax_c``, ``p999_c``); the
    reference's ``_calib_sows``."""
    absx = x.detach().float().abs()
    per_c = absx.reshape(-1, absx.shape[-1])
    out = {}
    if "amax" in keys or "amax_c" in keys:
        amax_c = per_c.amax(dim=0)
        out.update(amax=amax_c.amax(), amax_c=amax_c)
    if "p999" in keys:
        out["p999"] = _percentile(absx.reshape(-1), 99.9)
    if "p999_c" in keys:
        out["p999_c"] = _percentile(per_c.t().contiguous(), 99.9)
    return {k: out[k] for k in keys}


@contextlib.contextmanager
def recording_stats(model: "DeepIMFlowNet", keys):
    """Within the block, every dynamic int8 layer of ``model`` records the
    :func:`layer_stats` ``keys`` of its input into the yielded dict
    ({layer: {stat: tensor}}, elementwise max over the calls); outside it,
    none are computed (a percentile of a full-size activation is a large
    selection)."""
    stats: dict[str, dict[str, torch.Tensor]] = {}
    model._calib_stats, model._calib_keys = stats, tuple(keys)
    try:
        yield stats
    finally:
        model._calib_stats = None


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

    ``quant="int8"`` runs the encoder convs and fc1/fc2 in int8 (the
    decoder, the mask head, fc_rot and fc_trans stay in ``dtype``) on the
    same parameters: ``state_dict()`` is the plain model's, so checkpoints
    load either way.  ``act_scales``, a plain attribute (neither parameter
    nor buffer), is the sorted ``((layer, scale), ...)`` of
    ``models/quant.py §calibrate_act_scales``: a layer named there
    quantizes its input with that static scale, the others per sample.
    :meth:`with_act_scales` gives the calibrated int8 twin that shares the
    parameters (flax's ``clone(act_scales=...)``).
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
        if quant not in ("none", "int8"):
            raise ValueError(f"quant={quant!r} is not 'none' or 'int8' (an int8_static "
                             "model is the int8 one with calibrated act_scales)")
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
        self.quant = quant
        self.act_scales: tuple = ()
        self._calib_stats = None  # recording_stats' dict while it is active
        self._scale_cache = None  # act_scales as device tensors, by _act_scale
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

    def _conv1(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 + leaky on the NHWC input ``x`` -> NCHW (channels-last
        strides), in the compute type.

        On the network's 6 (or 10) input channels cuDNN falls back to a
        CUDA-core engine; on 8 it takes an Ampere-style tensor-core kernel;
        on the 32 channels of the folded input below it runs its Hopper
        implicit GEMM, about 3x faster again (H100, bf16, B=128).  So conv1
        runs as the exact space-to-depth rewrite of the reference's
        ``StemConv``: the padded input, its channels zero-extended to a
        multiple of :data:`CONV1_CHANNELS`, folded by 2 into 4x the
        channels, against the 7x7 kernel zero-extended to 8x8 and folded
        alike, a 4x4 stride-1 conv.  One zeroed buffer and four strided
        writes (one a row and column parity) do the cast, the border, the
        zero channels and the fold; a padded extent is rounded up to even,
        which adds no output.  The weight is rebuilt per call from the
        parameter, which keeps its shape, so its gradient is the real
        taps'.  The added products are exact zeros."""
        conv = self.conv1
        cout, cin, k, _ = conv.weight.shape
        cp, kb = _ceil_to(cin, CONV1_CHANNELS), -(-k // 2)
        b, h, w = x.shape[:3]
        if self.mxnet_pad:
            (ht, hb) = (wl, wr) = (k // 2, k // 2)
        else:
            (ht, hb), (wl, wr) = same_pad(h, k, 2), same_pad(w, k, 2)
        h2, w2 = -(-(h + ht + hb) // 2), -(-(w + wl + wr) // 2)
        with stage("network.conv1", cin=cin, cin_padded=cp):
            xs = x.new_zeros((b, h2, w2, 2, 2, cp), dtype=self.dtype)
            for p in (0, 1):  # padded row y + ht = 2 * i + p
                for q in (0, 1):
                    y0, x0 = (p - ht) % 2, (q - wl) % 2
                    part = x[:, y0::2, x0::2]
                    i0, j0 = (y0 + ht) // 2, (x0 + wl) // 2
                    xs[:, i0:i0 + part.shape[1], j0:j0 + part.shape[2], p, q, :cin] = part
            weight = F.pad(conv.weight.to(self.dtype),
                           (0, 2 * kb - k, 0, 2 * kb - k, 0, cp - cin))
            weight = (weight.reshape(cout, cp, kb, 2, kb, 2).permute(0, 3, 5, 1, 2, 4)
                      .reshape(cout, 4 * cp, kb, kb))
            y = F.conv2d(xs.view(b, h2, w2, 4 * cp).permute(0, 3, 1, 2), weight,
                         conv.bias.to(self.dtype))
            return leaky(y)

    def _up(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A 4x4/s2 transposed conv with flax's SAME (output 2n)."""
        conv = getattr(self, name)
        return F.conv_transpose2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                  stride=2, padding=1)

    @staticmethod
    def _linear(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """``lin`` in ``x``'s dtype; a tensor-parallel shard of fc1 or fc2
        (``parallel/mesh.py``) applies itself, with its collective."""
        if not isinstance(lin, nn.Linear):
            return lin(x)
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

    def with_act_scales(self, act_scales: tuple) -> "DeepIMFlowNet":
        """The int8 twin of this model with static ``act_scales``: a shallow
        copy sharing every parameter, buffer and submodule."""
        twin = copy.copy(self)
        twin.quant = "int8"
        twin.act_scales = tuple(act_scales)
        twin._calib_stats = None
        twin._scale_cache = None
        return twin

    def _act_scale(self, name: str, device: torch.device) -> torch.Tensor | None:
        """The static scale of layer ``name`` as a float32 tensor on
        ``device`` (0-d, or per channel), or None: made once per
        ``act_scales`` (fc1's per-feature tuple has 81,920 entries)."""
        if self._scale_cache is None or self._scale_cache[0] is not self.act_scales:
            self._scale_cache = (self.act_scales, dict(self.act_scales), {})
        _, scales, tensors = self._scale_cache
        if name not in scales:
            return None
        key = (name, str(device))
        if key not in tensors:
            tensors[key] = _f32(scales[name], device)
        return tensors[key]

    def _record(self, name: str, x: torch.Tensor) -> None:
        """Calibration: keep ``x``'s statistics while recording_stats is on."""
        if self._calib_stats is None:
            return
        new = layer_stats(x, self._calib_keys)
        old = self._calib_stats.get(name)
        self._calib_stats[name] = new if old is None else {
            k: torch.maximum(old[k], v) for k, v in new.items()}

    def _qconv(self, name: str, x: torch.Tensor, sym: bool) -> torch.Tensor:
        """One int8 encoder conv + leaky, NHWC in and out."""
        conv = getattr(self, name)
        k, s = conv.kernel_size[0], conv.stride[0]
        if sym:
            pads = (k // 2,) * 4
        else:
            pads = (*same_pad(x.shape[1], k, s), *same_pad(x.shape[2], k, s))
        scale = self._act_scale(name, x.device)
        if scale is None:
            self._record(name, x)
        y = int8_conv(x, conv.weight, s, pads, act_scale=scale)
        return leaky((y + conv.bias).to(self.dtype))

    def _qlinear(self, name: str, h: torch.Tensor) -> torch.Tensor:
        """int8 fc1/fc2: the leaky in float32, then the compute type."""
        lin = getattr(self, name)
        scale = self._act_scale(name, h.device)
        if scale is None:
            self._record(name, h)
        return leaky(int8_linear(h, lin.weight, lin.bias, act_scale=scale)).to(self.dtype)

    def forward(self, x: torch.Tensor, pose_only: bool = False) -> dict[str, torch.Tensor]:
        decode = (self.with_flow or self.with_mask) and not pose_only
        quant = self.quant == "int8"
        c = x.to(self.dtype) if quant else x
        skips = {}
        for name, *_ in ENCODER:
            if quant:  # NHWC throughout, the reference's layout
                c = self._qconv(name, c, self.mxnet_pad)
            elif name == "conv1":  # NHWC in, NCHW (channels-last strides) out
                c = self._conv1(c)
            else:
                c = self._conv(name, c, self.mxnet_pad)
            if decode and name in SKIPS.values():
                skips[name] = c.permute(0, 3, 1, 2) if quant else c
        if quant:
            c = c.permute(0, 3, 1, 2)
        out = self._decode(c, skips) if decode else {}
        if self.pose_head == "gap":
            h = c.mean(dim=(2, 3))
        else:
            if self.head_grid is not None and tuple(c.shape[2:]) != self.head_grid:
                c = F.interpolate(c, size=self.head_grid, mode="bilinear",
                                  align_corners=False, antialias=False)
            h = c.permute(0, 2, 3, 1).reshape(c.shape[0], -1)  # NHWC flatten
        if quant:
            h = self._qlinear("fc2", self._qlinear("fc1", h)).float()
        else:
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
