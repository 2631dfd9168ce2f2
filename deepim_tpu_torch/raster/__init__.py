"""Mesh rasterization for the crop renders of the refine loop (torch).

Port of ``deepim_tpu/raster``:

- :mod:`~deepim_tpu_torch.raster.mesh` — numpy mesh containers and builders.
- :mod:`~deepim_tpu_torch.raster.camera` — intrinsics bookkeeping.
- :mod:`~deepim_tpu_torch.raster.raster_ref` — brute-force oracle renderer.
- :mod:`~deepim_tpu_torch.raster.raster_cuda` — packing, sort binning and
  the two hand-written CUDA raster kernels (the production path).
"""
