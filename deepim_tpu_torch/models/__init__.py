"""The DeepIM FlowNetS network (pose-only forward) and the flax bridge.

Port of ``deepim_tpu/models/flownet.py``; ``bridge.py`` carries flax
parameter trees into this package's ``state_dict`` and back.
"""
