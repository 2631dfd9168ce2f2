"""Flax parameter tree <-> :class:`DeepIMFlowNet` ``state_dict``.

New in the port (no reference counterpart).  It takes and gives numpy
arrays, so it never needs jax: turn a flax ``variables["params"]`` tree
into numpy first (``jax.tree.map(np.asarray, params)``).

- Conv kernels go from flax HWIO to torch OIHW (``<name>/Conv_0/kernel``
  -> ``<name>.weight`` for the ``Conv`` wrapper's layers, the encoder and
  ``mask_conv``; ``<name>/kernel`` for the bare ``predict_flow*`` and
  ``mask_pred``).
- Transposed-conv kernels go from flax (kh, kw, in, out) to torch's
  (in, out, kh, kw), flipped in both spatial axes: flax's
  ``ConvTranspose`` correlates with its kernel as stored, torch's
  ``conv_transpose2d`` flips it (``deconv*/ConvTranspose_0/kernel``,
  ``upsample_flow*/kernel``).  The flip and the axis swap are their own
  inverses, so the trip back is exact.
- Dense kernels go from (in, out) to ``nn.Linear``'s (out, in).  fc1's
  rows need no permutation: the torch model flattens its bottleneck in
  the reference's NHWC order.

``flax_to_torch(torch_to_flax(sd)) == sd`` exactly, with or without the
decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from deepim_tpu_torch.models.flownet import DECODER, ENCODER, FLOW_LEVELS

DENSES = ("fc1", "fc2", "fc_rot", "fc_trans")
# Layers whose flax params sit under a "Conv_0"/"ConvTranspose_0" child
# (the reference's Conv and Deconv wrappers) or directly under the name.
WRAPPED_CONVS = tuple(name for name, *_ in ENCODER) + ("mask_conv",)
BARE_CONVS = tuple(f"predict_flow{lvl}" for lvl in FLOW_LEVELS) + ("mask_pred",)
WRAPPED_DECONVS = tuple(f"deconv{lvl}" for lvl, _ in DECODER)
BARE_DECONVS = tuple(f"upsample_flow{lvl + 1}to{lvl}" for lvl, _ in DECODER)
#: state_dict prefixes of the decoder and mask head, which the pose-only
#: forward never runs.
DECODER_LAYERS = BARE_CONVS + WRAPPED_DECONVS + BARE_DECONVS + ("mask_conv",)

_CHILD = {**dict.fromkeys(WRAPPED_CONVS, "Conv_0"),
          **dict.fromkeys(WRAPPED_DECONVS, "ConvTranspose_0")}
_KIND = {**dict.fromkeys(WRAPPED_CONVS + BARE_CONVS, "conv"),
         **dict.fromkeys(WRAPPED_DECONVS + BARE_DECONVS, "deconv"),
         **dict.fromkeys(DENSES, "dense")}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _to_torch(kind: str, kernel: np.ndarray) -> np.ndarray:
    if kind == "conv":
        return np.transpose(kernel, (3, 2, 0, 1))
    if kind == "deconv":
        return np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return np.transpose(kernel)


def _to_flax(kind: str, weight: np.ndarray) -> np.ndarray:
    if kind == "conv":
        return np.transpose(weight, (2, 3, 1, 0))
    if kind == "deconv":
        return np.transpose(weight[:, :, ::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(weight)


def flax_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree (numpy leaves) -> ``state_dict`` of the port."""
    sd = {}
    for name, sub in params.items():
        if name not in _KIND:
            raise KeyError(f"unknown flax parameter subtree {name!r}")
        leaf = sub[_CHILD[name]] if name in _CHILD else sub
        sd[f"{name}.weight"] = _t(_to_torch(_KIND[name], np.asarray(leaf["kernel"])))
        sd[f"{name}.bias"] = _t(leaf["bias"])
    return sd


def torch_to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """``state_dict`` of the port -> flax ``params`` tree of numpy arrays."""
    params: dict = {}
    for key, value in state_dict.items():
        name, kind = key.rsplit(".", 1)
        if name not in _KIND:
            raise KeyError(f"unknown state_dict entry {key!r}")
        a = value.detach().cpu().to(torch.float32).numpy()
        leaf = params.setdefault(name, {})
        if name in _CHILD:
            leaf = leaf.setdefault(_CHILD[name], {})
        if kind == "weight":
            leaf["kernel"] = np.ascontiguousarray(_to_flax(_KIND[name], a))
        else:
            leaf["bias"] = np.ascontiguousarray(a)
    return params
