"""Pose sampling, on-device pair synthesis, image IO, the on-disk datasets
and the toolkits.

Port of ``deepim_tpu/data/pairs.py`` (``sample_poses_in_frustum``,
``perturb_poses``), ``deepim_tpu/data/synthetic.py`` (``random_lighting``,
``synthetic_batch``, ``synthetic_occlusion_batch``),
``deepim_tpu/data/lm6d.py`` (the LM6d layout, its readers, streaming
loaders and ``TrainBatcher``), ``deepim_tpu/data/toolkit.py`` (an LM6d
root generated on the device) and ``deepim_tpu/data/video.py``
(``VideoDataset``, ``gen_video``, the YCB-Video keyframe protocol,
``convert_ycb_original``), ``deepim_tpu/data/bop.py``,
``lm_original.py`` and ``validate.py`` (the public releases' converters and
the preflight), with the port's own PNG codec (``png.py``) and baseline
JPEG decoder (``jpeg.py``).
"""

from deepim_tpu_torch.data.jpeg import decode_jpeg, imread
from deepim_tpu_torch.data.lm6d import (
    DEPTH_FACTOR, FrameRecord, LM6DDataset, TrainBatcher, apply_bop_init, iter_frame_batches,
    prefetch_iter, to_device)
from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
from deepim_tpu_torch.data.png import decode_png, encode_png, read_png, write_png
from deepim_tpu_torch.data.synthetic import (
    random_lighting,
    synthetic_batch,
    synthetic_occlusion_batch,
)
from deepim_tpu_torch.data.video import VideoDataset, gen_video, read_manifest, video_manifest
