"""Model construction and checkpoints of the port (``deepim_tpu/train``).

Inference only so far: :func:`make_model` and the torch checkpoint format
of :mod:`~deepim_tpu_torch.train.checkpoint`.  The training step, the
optimizer and ``init_state`` are ROADMAP A12.
"""

from deepim_tpu_torch.train.checkpoint import (
    checkpoint_dir,
    clear_checkpoints,
    import_flax_params,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from deepim_tpu_torch.train.train import make_model
