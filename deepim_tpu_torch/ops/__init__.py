"""Image ops of the refine loop: the zoom crop and its resampler (torch).

Port of ``deepim_tpu/ops`` (``zoom.py``, ``resample.py``, ``flow_gt.py``),
with the reference's exports.
"""

from deepim_tpu_torch.ops.flow_gt import calc_flow
from deepim_tpu_torch.ops.resample import (
    affine_grid,
    bilinear_sample,
    nearest_sample,
    resample_affine,
)
from deepim_tpu_torch.ops.zoom import (
    ZoomBox,
    compute_zoom_box,
    model_corners,
    unzoom_points,
    zoom_flow,
    zoom_image,
    zoom_intrinsics,
)
