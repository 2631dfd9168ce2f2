"""SE(3) / rotation math for pose refinement (torch).

Port of ``deepim_tpu/geometry``: rotations, se3, the untangled delta pose,
the pose error metrics and the (numpy) symmetry sets.
"""

from deepim_tpu_torch.geometry.delta_pose import DeltaPose, apply_delta, calc_delta
from deepim_tpu_torch.geometry.rotations import (
    axangle2mat,
    axangle2quat,
    euler2mat,
    euler2quat,
    mat2euler,
    mat2quat,
    quat2euler,
    quat2mat,
    quat_conjugate,
    quat_mul,
    quat_normalize,
    quat_slerp,
    random_quat,
    rotation_angle,
)
from deepim_tpu_torch.geometry.pose_errors import (
    add_auc,
    add_error,
    adds_error,
    proj2d_error,
    rot_error_deg,
    trans_error,
)
from deepim_tpu_torch.geometry.se3 import (
    project_points,
    se3_from_rt,
    se3_inverse,
    se3_mul,
    transform_points,
)
from deepim_tpu_torch.geometry.symmetry import (
    LINEMOD_SYMMETRIC,
    YCB_SYMMETRIC,
    identity_pose,
    rot_z_syms,
    sym_set,
)
