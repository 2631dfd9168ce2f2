"""Training of the port (``deepim_tpu/train``): the network builder, the
losses' assembly, the optimizer and schedule, the train steps (a given
batch, or synthesis and step fused on the device) and the torch checkpoint
format of :mod:`~deepim_tpu_torch.train.checkpoint`.  The driver is
:mod:`deepim_tpu_torch.cli.train`.
"""

from deepim_tpu_torch.train.checkpoint import (
    checkpoint_dir,
    clear_checkpoints,
    import_flax_params,
    latest_step,
    load_params,
    merge_pretrained,
    restore_checkpoint,
    restore_params_raw,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)
from deepim_tpu_torch.train.train import (
    TrainState,
    compute_losses,
    init_state,
    make_lr_schedule,
    make_model,
    make_optimizer,
    make_synthetic_train_step,
    make_train_step,
)
