"""Training losses: point matching (symmetry-aware), flow EPE pyramid, mask CE.

Port of ``deepim_tpu/losses``.
"""

from deepim_tpu_torch.losses.losses import (
    FLOW_LEVEL_WEIGHTS,
    angle_trans_l1_loss,
    flow_epe_loss,
    mask_ce_loss,
    point_matching_loss,
)
