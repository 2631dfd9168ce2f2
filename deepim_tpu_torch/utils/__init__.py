"""Utilities: result records, visualization, logging and profiling.

Port of ``deepim_tpu/utils/results.py``, ``viz.py``, ``logging.py`` and
``profiling.py``.  ``deepim_tpu/utils/platform.py`` (which pins JAX's
platform) has no counterpart: the port's entry points take ``--device``.
"""

from deepim_tpu_torch.utils.results import record_result
from deepim_tpu_torch.utils.viz import (
    flow_to_rgb,
    mask_to_rgb,
    overlay_render,
    save_image,
    side_by_side,
)
from deepim_tpu_torch.utils.logging import MetricsLogger, PrintAndLog, mkdir_if_missing
from deepim_tpu_torch.utils.profiling import clear_spans, dropped_spans, spans, stage, trace
