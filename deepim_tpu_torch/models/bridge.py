"""Flax parameter tree <-> :class:`DeepIMFlowNet` ``state_dict``.

New in the port (no reference counterpart).  It takes and gives numpy
arrays, so it never needs jax: turn a flax ``variables["params"]`` tree
into numpy first (``jax.tree.map(np.asarray, params)``).

- Conv kernels go from flax HWIO to torch OIHW (``<name>/Conv_0/kernel``
  -> ``<name>.weight``).
- Dense kernels go from (in, out) to ``nn.Linear``'s (out, in).  fc1's
  rows need no permutation: the torch model flattens its bottleneck in
  the reference's NHWC order.
- The decoder and mask head subtrees (not ported yet) are skipped.

``flax_to_torch(torch_to_flax(sd))`` returns ``sd`` exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from deepim_tpu_torch.models.flownet import ENCODER

CONVS = tuple(name for name, *_ in ENCODER)
DENSES = ("fc1", "fc2", "fc_rot", "fc_trans")
# Flax subtrees of the flow decoder and mask head, which the pose-only
# forward does not run.
SKIPPED = ("deconv", "upsample_flow", "predict_flow", "mask_conv", "mask_pred")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def flax_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree (numpy leaves) -> ``state_dict`` of the port."""
    sd = {}
    for name, sub in params.items():
        if name in CONVS:
            leaf = sub["Conv_0"]
            sd[f"{name}.weight"] = _t(np.transpose(leaf["kernel"], (3, 2, 0, 1)))
            sd[f"{name}.bias"] = _t(leaf["bias"])
        elif name in DENSES:
            sd[f"{name}.weight"] = _t(np.transpose(sub["kernel"]))
            sd[f"{name}.bias"] = _t(sub["bias"])
        elif not name.startswith(SKIPPED):
            raise KeyError(f"unknown flax parameter subtree {name!r}")
    return sd


def torch_to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """``state_dict`` of the port -> flax ``params`` tree of numpy arrays."""
    params: dict = {}
    for key, value in state_dict.items():
        name, kind = key.rsplit(".", 1)
        a = value.detach().cpu().to(torch.float32).numpy()
        if name in CONVS:
            leaf = params.setdefault(name, {}).setdefault("Conv_0", {})
            leaf["kernel" if kind == "weight" else "bias"] = np.ascontiguousarray(
                np.transpose(a, (2, 3, 1, 0)) if kind == "weight" else a)
        elif name in DENSES:
            params.setdefault(name, {})[
                "kernel" if kind == "weight" else "bias"] = np.ascontiguousarray(
                    a.T if kind == "weight" else a)
        else:
            raise KeyError(f"unknown state_dict entry {key!r}")
    return params
