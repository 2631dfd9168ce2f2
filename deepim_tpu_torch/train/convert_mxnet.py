"""MXNet checkpoint -> the port's ``state_dict`` (and back).

Port of ``deepim_tpu/train/convert_mxnet.py``.  The MXNet DeepIM ships
``.params`` checkpoints (``arg:<name>`` / ``aux:<name>`` arrays) with
FlowNetS layer names; exported without MXNet they are a ``.npz`` of the
same keys (:func:`load_mxnet_npz`).  :func:`convert_mxnet_dict` lays them
onto a :class:`~deepim_tpu_torch.models.flownet.DeepIMFlowNet`
``state_dict``:

- conv weights: MXNet OIHW is torch's ``Conv2d`` layout, as is;
- FC weights: MXNet (out, in) is ``nn.Linear``'s, as is;
- deconv weights: MXNet's ``Deconvolution`` weight is (in, out, kh, kw)
  and the layer is the gradient of a conv, which is exactly
  ``nn.ConvTranspose2d``'s layout and meaning.  The reference flips the
  kernel for flax's ``ConvTranspose`` (``flip_deconv=True``) and the bridge
  (``models/bridge.py``) flips it back for torch, so at ``flip_deconv=True``
  the torch weight is the MXNet tensor unflipped.  ``flip_deconv`` keeps
  the reference's meaning: for either value the converted network computes
  what the reference network computes after the reference's conversion
  (``flip_deconv=False`` flips the torch kernel).

The converted network needs ``network.mxnet_pad`` (MXNet pads convs
``k//2`` on both sides; see ``models/flownet.py``).
:func:`export_mxnet_npz` is the inverse (the reference's
``export_flax_to_mxnet_npz`` composed with the bridge).
"""

from __future__ import annotations

import numpy as np
import torch

# the port's module name -> the MXNet layer's base name
NAME_MAP = {name: name for name in (
    "conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1", "conv5", "conv5_1",
    "conv6", "conv6_1", "predict_flow6", "predict_flow5", "predict_flow4",
    "predict_flow3", "predict_flow2", "deconv5", "deconv4", "deconv3", "deconv2",
    "upsample_flow6to5", "upsample_flow5to4", "upsample_flow4to3", "upsample_flow3to2",
    "fc1", "fc2", "fc_rot", "fc_trans")}

_DECONV_LAYERS = {
    "deconv5", "deconv4", "deconv3", "deconv2",
    "upsample_flow6to5", "upsample_flow5to4", "upsample_flow4to3", "upsample_flow3to2",
}


def _modules(state_dict: dict) -> list[str]:
    """Module names of a ``state_dict`` in order (``conv1.weight`` -> conv1)."""
    names: list[str] = []
    for key in state_dict:
        name = key.rsplit(".", 1)[0]
        if name not in names:
            names.append(name)
    return names


def _deconv_weight(w: np.ndarray, flip: bool) -> np.ndarray:
    """MXNet deconv weight -> the torch one that computes what the
    reference's flax layer computes after its ``deconv_iohw_to_hwio(w,
    flip)``: two flips (the reference's and the bridge's) cancel."""
    return w if flip else w[:, :, ::-1, ::-1]


def convert_mxnet_dict(mx_params: dict[str, np.ndarray], state_dict: dict[str, torch.Tensor],
                       flip_deconv: bool = True, strict: bool = False
                       ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Overlay MXNet tensors onto a ``state_dict`` -> (new state_dict,
    missing module names).

    A layer without an MXNet tensor keeps its initial weights and is named
    in ``missing``; one whose shape differs is named ``"<name> (shape
    mismatch)"`` and kept, or raises ``ValueError`` when ``strict``.
    """

    def get(name):
        for key in (f"arg:{name}", name):
            if key in mx_params:
                return np.asarray(mx_params[key])
        return None

    new = dict(state_dict)
    missing = []
    for mod in _modules(state_dict):
        base = NAME_MAP.get(mod, mod)
        w = get(f"{base}_weight")
        b = get(f"{base}_bias")
        if w is None:
            missing.append(mod)
            continue
        if mod in _DECONV_LAYERS:
            w = _deconv_weight(w, flip_deconv)
        tgt = state_dict[f"{mod}.weight"]
        if tuple(w.shape) != tuple(tgt.shape):
            msg = f"{mod}: mxnet {tuple(w.shape)} vs torch {tuple(tgt.shape)}"
            if strict:
                raise ValueError(msg)
            missing.append(mod + " (shape mismatch)")
            continue
        new[f"{mod}.weight"] = torch.from_numpy(np.array(w, np.float32, order="C"))
        if b is not None and f"{mod}.bias" in state_dict:
            new[f"{mod}.bias"] = torch.from_numpy(np.array(b, np.float32, order="C"))
    return new, missing


def load_mxnet_npz(path: str) -> dict[str, np.ndarray]:
    """An exported MXNet checkpoint (.npz of arg:/aux: arrays)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def export_mxnet_npz(state_dict: dict[str, torch.Tensor], path: str,
                     flip_deconv: bool = True) -> None:
    """The inverse of :func:`convert_mxnet_dict`: a ``state_dict`` -> an
    ``arg:<name>_weight`` / ``_bias`` npz, which the reference's
    ``convert_mxnet_dict`` reads into the same network."""
    out = {}
    for mod in _modules(state_dict):
        base = NAME_MAP.get(mod, mod)
        w = state_dict[f"{mod}.weight"].detach().cpu().to(torch.float32).numpy()
        if mod in _DECONV_LAYERS:
            w = _deconv_weight(w, flip_deconv)
        out[f"arg:{base}_weight"] = np.ascontiguousarray(w)
        if f"{mod}.bias" in state_dict:
            out[f"arg:{base}_bias"] = (
                state_dict[f"{mod}.bias"].detach().cpu().to(torch.float32).numpy())
    np.savez(path, **out)
