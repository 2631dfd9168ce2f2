"""The render -> zoom -> CNN -> compose refinement loop (torch).

Port of ``deepim_tpu/refine/refiner.py``.
"""

from deepim_tpu_torch.refine.refiner import (
    RenderAssets,
    build_assets,
    gather_class,
    refine_poses,
    refine_step,
    render_crops,
)
