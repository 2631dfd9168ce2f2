"""Pose sampling and on-device pair synthesis (torch).

Port of ``deepim_tpu/data/pairs.py`` (``sample_poses_in_frustum``,
``perturb_poses``) and ``deepim_tpu/data/synthetic.py``
(``random_lighting``, ``synthetic_batch``, ``synthetic_occlusion_batch``).
"""

from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
from deepim_tpu_torch.data.synthetic import (
    random_lighting,
    synthetic_batch,
    synthetic_occlusion_batch,
)
