"""The render -> zoom -> CNN -> compose refinement loop (torch).

Port of ``deepim_tpu/refine``: the loop (``refiner.py``), multi-hypothesis
selection (``hypotheses.py``) and video tracking (``video.py``).
"""

from deepim_tpu_torch.refine.refiner import (
    RenderAssets,
    build_assets,
    gather_class,
    refine_poses,
    refine_step,
    render_crops,
    render_scene,
)
from deepim_tpu_torch.refine.hypotheses import (
    draw_hypotheses,
    refine_multi_hypothesis,
    score_poses,
    select_hypotheses,
)
from deepim_tpu_torch.refine.video import refine_video
