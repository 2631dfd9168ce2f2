"""Config system (dataclass defaults + YAML overlay).

Port of ``deepim_tpu/config``.
"""

from deepim_tpu_torch.config.config import (
    Config,
    DatasetConfig,
    NetworkConfig,
    TestConfig,
    TrainConfig,
    config_from_dict,
    save_config,
    update_config,
)
