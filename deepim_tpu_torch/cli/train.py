"""The asset loader of the training driver (``deepim_tpu/cli/train.py``).

Only :func:`load_assets_and_names` is ported: the service and the later
drivers build their render assets with it.  The training driver itself is
ROADMAP A12.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from deepim_tpu_torch.geometry.symmetry import (
    CONTINUOUS_Z, LINEMOD_SYMMETRIC, PROCEDURAL_SYMMETRIC, YCB_SYMMETRIC)
from deepim_tpu_torch.raster.mesh import (
    PROCEDURAL_MESHES, ZOO_FAMILIES, random_mesh_zoo, texturize)
from deepim_tpu_torch.refine.refiner import RenderAssets, build_assets

# Zoo families that are continuously z-symmetric, like their canonical
# shapes.
_CONTINUOUS_ZOO = ("zoo_cyl", "zoo_torus", "zoo_cone", "zoo_capsule", "zoo_frustum",
                   "zoo_tube")


def _symmetry(name: str, table: dict):
    if name.startswith(_CONTINUOUS_ZOO):
        return CONTINUOUS_Z
    # Dense stand-ins share their base shape's symmetry.
    return table.get(re.sub(r"_dense\d*$", "", name), table.get(name))


def load_assets_and_names(cfg, eval_set: bool = False,
                          device: torch.device | str = "cuda"
                          ) -> tuple[RenderAssets, list[str], list[bool]]:
    """Meshes per ``cfg.dataset`` -> (RenderAssets on ``device``, class
    names, symmetric flags).

    ``eval_set`` selects ``cfg.dataset.eval_objects`` when there are any
    (the ModelNet unseen-category protocol).  ``synthetic*`` datasets and
    the ``modelnet`` zoo are built here; the datasets read from disk
    (``lm6d``, ``ycb``, a ModelNet ``cad_dir``) need the mesh loaders,
    which are not ported yet, and raise ``NotImplementedError`` rather
    than serve other meshes.  ``texture_prob`` textures the procedural
    meshes; the coarse LOD (``lod_faces``) is built only when
    ``test.coarse_iters`` > 0, the only time it renders.
    """
    d = cfg.dataset
    names = list(d.eval_objects) if eval_set and d.eval_objects else list(d.objects)
    if d.name == "modelnet" and eval_set and d.cad_dir:
        raise NotImplementedError(
            "dataset.cad_dir: loading CAD meshes from disk is not ported yet "
            "(ROADMAP A13)")
    if d.name == "modelnet" and not (eval_set and d.eval_objects):
        zoo = random_mesh_zoo(d.zoo_size, d.zoo_seed, tuple(d.zoo_families) or ZOO_FAMILIES,
                              texture_prob=d.texture_prob)
        names = list(zoo)
        meshes = [zoo[n] for n in names]
    elif d.name.startswith("synthetic") or d.name == "modelnet":
        meshes = [PROCEDURAL_MESHES[n]() for n in names]
        if d.texture_prob > 0.0:
            rng_tex = np.random.RandomState(d.zoo_seed)
            meshes = [texturize(m, d.zoo_seed * 100003 + i)
                      if rng_tex.rand() < d.texture_prob else m
                      for i, m in enumerate(meshes)]
    else:
        raise NotImplementedError(
            f"dataset.name={d.name!r}: the on-disk dataset loaders are not "
            "ported yet (ROADMAP A13)")
    table = {**LINEMOD_SYMMETRIC, **YCB_SYMMETRIC, **PROCEDURAL_SYMMETRIC}
    syms = [_symmetry(n, table) for n in names]
    use_tex = {"auto": None, "on": True, "off": False}[d.use_textures]
    lod = d.lod_faces if cfg.test.coarse_iters > 0 else None
    assets = build_assets(meshes, sym_transforms=syms, num_points=d.num_points,
                          use_textures=use_tex, lod_faces=lod or None, device=device)
    return assets, names, [s is not None for s in syms]
