"""Calibrated static-scale int8 inference (``network.quant: int8_static``).

Port of ``deepim_tpu/models/quant.py``.  Calibration runs the dynamic int8
model itself: inside :func:`~deepim_tpu_torch.models.flownet.recording_stats`
every quantized layer records the statistics of its input (max |x| and
its 99.9th percentile, over the tensor and per channel), so forward passes
over representative inputs give per-layer static scales.  The scales ride
the model as the plain attribute ``act_scales`` (a sorted tuple of
``(layer_name, scale)``), never the checkpoint: the calibrated model is
:meth:`~deepim_tpu_torch.models.flownet.DeepIMFlowNet.with_act_scales`, a
twin that shares the parameters.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from deepim_tpu_torch.config.config import QUANT_MODES  # noqa: F401 (re-export)
from deepim_tpu_torch.models.flownet import DeepIMFlowNet, recording_stats

__all__ = ["CALIB_MODES", "calibrate_act_scales", "calibrate_model", "QUANT_MODES"]

#: Estimators of the static activation scale: "max" is plain max |x| (no
#: clipping); "p999" clips the top 0.1 % of |x|; the "_c" variants measure
#: per input channel and fold the scales into the consuming layer's
#: weights.  "max_c" is the default of the entry points (cli.test
#: --quant-calib, the service, calibrate_model), as in the reference.
CALIB_MODES = ("max", "p999", "max_c", "p999_c")
_STAT_KEY = {"max": "amax", "p999": "p999", "max_c": "amax_c", "p999_c": "p999_c"}


def _to_scale(v: np.ndarray):
    s = np.where(v > 0, v, 1.0) / 127.0
    if s.ndim == 0:
        return float(s)
    return tuple(float(e) for e in s)


@torch.no_grad()
def calibrate_act_scales(model: DeepIMFlowNet, inputs: Iterable[torch.Tensor],
                         mode: str = "max") -> tuple:
    """Per-layer activation statistics of the dynamic int8 ``model`` over
    ``inputs`` (assembled (B, H, W, C) network-input batches; build them
    with ``refine.build_network_inputs`` so calibration sees the true input
    distribution) -> the sorted tuple of ``(layer_name, scale)`` for
    ``model.with_act_scales``.  The statistic of ``mode`` (see
    :data:`CALIB_MODES`) aggregates across batches with an elementwise max
    in float64; scale = stat / 127 (a zero statistic gives 1 / 127).
    Per-channel modes give tuple-valued scales."""
    if mode not in CALIB_MODES:
        raise ValueError(f"mode={mode!r} not in {CALIB_MODES}")
    want = _STAT_KEY[mode]
    dynamic = model.with_act_scales(())
    stat: dict[str, np.ndarray] = {}
    n_batches = 0
    for x in inputs:
        n_batches += 1
        with recording_stats(dynamic, (want,)) as stats:
            dynamic(x, pose_only=True)
        for name, values in stats.items():
            value = values[want].double().cpu().numpy()
            stat[name] = value if name not in stat else np.maximum(stat[name], value)
    if n_batches == 0:
        raise ValueError("calibrate_act_scales needs >=1 input batch")
    return tuple(sorted((k, _to_scale(v)) for k, v in stat.items()))


@torch.no_grad()
def calibrate_model(model: DeepIMFlowNet, assets, batches: Iterable[dict],
                    k_cam: torch.Tensor, out_size: tuple[int, int], num_iters: int = 4,
                    mode: str = "max_c", zoom_margin: float = 1.4) -> DeepIMFlowNet:
    """Eval batches -> the calibrated ``int8_static`` model.

    ``batches`` iterates eval-style batch dicts on the assets' device
    (``obs_rgb``, ``pose_src``, ``class_idx`` [, ``obs_mask``,
    ``obs_depth``]).  Each batch walks ``num_iters`` refine iterations
    (``refine_step`` with ``model``) at ``out_size`` and the network input
    is measured at every iteration, not just at the init pose: in the
    reference, scales from iteration-1 inputs alone were measured
    catastrophically wrong on the flagship protocol (later iterations see
    sharply aligned pairs whose activations exceed the init-pose range,
    and static scales clip beyond it).  The returned twin shares
    ``model``'s parameters.
    """
    from deepim_tpu_torch.refine.refiner import build_network_inputs, gather_class, refine_step

    def inputs():
        for b in batches:
            pose, cls, obs = b["pose_src"], b["class_idx"], b["obs_rgb"]
            ks = k_cam.expand(pose.shape[0], 3, 3)
            obs_mask, obs_depth = b.get("obs_mask"), b.get("obs_depth")
            ab = gather_class(assets, cls)
            for it in range(num_iters):
                yield build_network_inputs(model, ab, obs, pose, ks, out_size, zoom_margin,
                                           obs_mask=obs_mask, obs_depth=obs_depth).x
                if it + 1 < num_iters:
                    pose = refine_step(model, ab, obs, pose, ks, cls, out_size, zoom_margin,
                                       obs_mask=obs_mask, obs_depth=obs_depth).pose

    return model.with_act_scales(calibrate_act_scales(model, inputs(), mode=mode))
