"""Building the network from a config (``deepim_tpu/train/train.py
§make_model``).

Inference only: the pose-only :class:`DeepIMFlowNet` the refine loop
runs.  ``network.with_flow``/``with_mask`` select the flow decoder and
mask head, which only training runs (the reference serves ``pose_only``),
so they have no effect here.  ``init_state``, the optimizer and the train
step are ROADMAP A12.
"""

from __future__ import annotations

import torch

from deepim_tpu_torch.models.flownet import DeepIMFlowNet, bottleneck_grid


def make_model(cfg, num_classes: int, inference: bool = False,
               generator: torch.Generator | None = None) -> DeepIMFlowNet:
    """The network of ``cfg.network`` on the CPU, its initial weights drawn
    from ``generator`` (flax's initialisers; identity pose heads).

    The flatten head is pinned to the full-resolution bottleneck grid
    (``head_grid``), so one set of weights also serves the coarse
    iterations.  ``inference=True`` applies ``network.quant``: int8 is not
    ported yet and raises ``NotImplementedError`` (ROADMAP A10).  A
    ``class_agnostic`` network has one head for all classes.
    """
    n = cfg.network
    if n.pose_head != "flatten":
        raise NotImplementedError(f"network.pose_head={n.pose_head!r}: only the "
                                  "flatten head is ported")
    if n.mxnet_pad:
        raise NotImplementedError("network.mxnet_pad: the MXNet padding of converted "
                                  "checkpoints is not ported")
    return DeepIMFlowNet(
        num_classes=1 if n.class_agnostic else num_classes,
        rot_type=n.rot_type,
        head_grid=bottleneck_grid(n.input_height, n.input_width),
        input_mask=n.input_mask,
        input_depth=n.input_depth,
        fc_dim=n.fc_dim,
        dtype=torch.bfloat16 if n.dtype == "bfloat16" else torch.float32,
        quant=n.quant if inference else "none",
        generator=generator,
    )
