"""SE(3) / rotation math for pose refinement (torch).

Port of ``deepim_tpu/geometry``: rotations, se3, the untangled delta pose
and the (numpy) symmetry sets.
"""

from deepim_tpu_torch.geometry.delta_pose import DeltaPose, apply_delta, calc_delta
from deepim_tpu_torch.geometry.rotations import (
    euler2mat,
    euler2quat,
    mat2quat,
    quat2mat,
    quat_normalize,
    random_quat,
)
from deepim_tpu_torch.geometry.se3 import project_points, se3_from_rt, transform_points
from deepim_tpu_torch.geometry.symmetry import identity_pose, rot_z_syms, sym_set
