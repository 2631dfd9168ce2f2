"""Utilities: result records and visualization (numpy, host-side).

Port of ``deepim_tpu/utils/results.py`` and ``deepim_tpu/utils/viz.py``.
"""

from deepim_tpu_torch.utils.results import record_result
from deepim_tpu_torch.utils.viz import (
    flow_to_rgb,
    mask_to_rgb,
    overlay_render,
    save_image,
    side_by_side,
)
