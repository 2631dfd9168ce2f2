"""Multi-process training and evaluation over ``torch.distributed``
(``deepim_tpu/parallel``): rank meshes, batch sharding, the gradient
all-reduce, the pose head's tensor parallelism, and process-group set-up
for ``--n-devices`` and ``torchrun``."""

from deepim_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_multihost,
    launch,
    process_local_batch_size,
    spawn,
)
from deepim_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    mean_gradients,
    replicate,
    shard_batch,
    shard_params_for_tp,
)
