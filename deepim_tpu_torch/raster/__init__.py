"""Mesh rasterization: crop renders, scenes and textures (torch).

Port of ``deepim_tpu/raster``:

- :mod:`~deepim_tpu_torch.raster.mesh` — numpy mesh containers, builders,
  texture helpers and PLY IO.
- :mod:`~deepim_tpu_torch.raster.camera` — intrinsics bookkeeping.
- :mod:`~deepim_tpu_torch.raster.raster_ref` — lighting and the
  brute-force oracle renderer.
- :mod:`~deepim_tpu_torch.raster.raster_cuda` — packing, binning, face
  chunking and the three hand-written CUDA raster kernels (the production
  path).
- :mod:`~deepim_tpu_torch.raster.textured` — the deferred-texture pass.
"""

from deepim_tpu_torch.raster.mesh import (
    Mesh,
    bake_texture_to_vertices,
    load_ply,
    make_mesh,
    planar_uv,
    procedural_texture,
    save_ply,
    texturize,
)
from deepim_tpu_torch.raster.raster_cuda import (
    bin_faces_topk,
    pack_face_params,
    pack_tri_params,
    raster_topk,
    raster_topk_ref,
    render_batch,
    render_batch_tri,
)
from deepim_tpu_torch.raster.raster_ref import FLAT_LIGHTING, Lighting
from deepim_tpu_torch.raster.textured import (
    pack_tri_params_uv,
    render_batch_textured,
    sample_texture_atlas,
    sample_texture_bilinear,
    tri_uv_corner_major,
)
