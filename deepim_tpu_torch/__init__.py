"""PyTorch + CUDA port of ``deepim_tpu`` for NVIDIA Hopper (H100).

The JAX package ``deepim_tpu`` is the reference; this package mirrors its
subpackages and function names so each counterpart is easy to find.  It
imports ``torch`` and numpy only (never jax), computes on the device of its
inputs, and draws random numbers from explicit ``torch.Generator``s.

The slice ported so far is the inference refine loop
(:func:`deepim_tpu_torch.refine.refine_poses`): render -> zoom -> FlowNetS
pose head -> untangled SE(3) compose.  Its two rasterizer kernels are
hand-written CUDA (``raster/csrc``), built at first use on the card.
"""
