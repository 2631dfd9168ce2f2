"""Serving layer: the batched pose-refinement service on the card.

Port of ``deepim_tpu/serve``.
"""

from deepim_tpu_torch.serve.service import PoseRefinerService, ServiceStats
