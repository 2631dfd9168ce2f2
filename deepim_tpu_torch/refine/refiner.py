"""The iterative render-and-compare refinement loop (torch).

Port of ``deepim_tpu/refine/refiner.py``: ``RenderAssets``/``build_assets``
(with the nested coarse ``lod`` and ``cull_dir``), ``gather_class``,
``render_crops`` with its crop-regime kernel dispatch,
``build_network_inputs``, ``refine_step`` and ``refine_poses`` (with
``coarse_iters``/``coarse_size`` and ``return_all``).  The reference's
``lax.scan`` over iterations is a Python loop here; everything is batched
over the hypothesis axis B and runs on the device of the inputs.

Textured meshes are refused by ``build_assets``: the texture atlas and
the deferred-texture raster path are not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from deepim_tpu_torch.geometry.delta_pose import DeltaPose, apply_delta
from deepim_tpu_torch.geometry.symmetry import CONTINUOUS_Z, CONTINUOUS_Z_DISCRETE, sym_set
from deepim_tpu_torch.models.flownet import decode_rot, network_input, normalize_depth, select_class
from deepim_tpu_torch.ops.zoom import (
    ZoomBox,
    compute_zoom_box,
    model_corners,
    zoom_image_batch,
    zoom_intrinsics,
)
from deepim_tpu_torch.raster import raster_cuda
from deepim_tpu_torch.raster.mesh import cull_direction, decimate_mesh, pad_mesh, sample_points
from deepim_tpu_torch.raster.raster_ref import FLAT_LIGHTING, Lighting

# Bound on one iteration's update: |vx|, |vy| <= 2000 crop px, |vz| <= 4.
_TRANS_CLIP = (2000.0, 2000.0, 4.0)


class RenderAssets(NamedTuple):
    """Per-class mesh data stacked to shared budgets (leading class axis C).

    ``tri_*`` are corner-major (C, 9, F): row 3*corner+coord holds that
    component for all F faces, gathered once at build time.
    """

    vertices: torch.Tensor  # (C, V, 3)
    faces: torch.Tensor  # (C, F, 3) int32 (degenerate-padded)
    colors: torch.Tensor  # (C, V, 3)
    normals: torch.Tensor  # (C, V, 3)
    corners: torch.Tensor  # (C, 8, 3) AABB corners (zoom bbox source)
    points: torch.Tensor  # (C, N, 3) sampled surface points
    sym_poses: torch.Tensor  # (C, S, 3, 4) symmetry set (identity-padded)
    diameters: torch.Tensor  # (C,)
    tri_pos: torch.Tensor  # (C, 9, F) object-frame corner positions
    tri_col: torch.Tensor  # (C, 9, F) corner colors
    tri_nrm: torch.Tensor  # (C, 9, F) corner normals
    sym_continuous: torch.Tensor | None = None  # (C,) bool
    cull_dir: torch.Tensor | None = None  # (C,) ±1 back-face cull sign, 0 = off
    lod: Any = None  # coarse RenderAssets for coarse iterations, or None

    @property
    def num_classes(self) -> int:
        return self.vertices.shape[0]

    def to(self, device) -> "RenderAssets":
        """The same assets on ``device`` (the nested ``lod`` too)."""
        return RenderAssets(*(
            None if a is None else a.to(device) for a in self))


def build_assets(meshes, sym_transforms=None, num_points: int = 3000,
                 lod_faces: int | None = None,
                 device: torch.device | str = "cpu") -> RenderAssets:
    """Stack host meshes into a RenderAssets on ``device``, padded to the
    set's largest vertex, face and symmetry counts.

    ``lod_faces`` builds the nested coarse level (every mesh decimated to
    that face budget) only when it at least halves the face table, as the
    reference does.  Textured meshes raise: their atlas and deferred-texture
    raster path are not ported yet.
    """
    if any(m.texture is not None for m in meshes):
        raise NotImplementedError(
            "textured meshes: the texture atlas and deferred-texture raster "
            "path are not ported yet (ROADMAP queue A, textured path)")
    sym_transforms = sym_transforms or [None] * len(meshes)
    sym_cont = np.asarray(
        [isinstance(s, str) and s == CONTINUOUS_Z for s in sym_transforms])
    mv = max(m.num_vertices for m in meshes)
    mf = max(m.num_faces for m in meshes)
    ms = max(
        (1 if s is None else CONTINUOUS_Z_DISCRETE if isinstance(s, str)
         else s.shape[0])
        for s in sym_transforms)
    lod = None
    if lod_faces and mf > 2 * lod_faces:
        lod = build_assets([decimate_mesh(m, lod_faces) for m in meshes],
                           sym_transforms=sym_transforms,
                           num_points=min(num_points, 16), device=device)
    padded = [pad_mesh(m, mv + 1, mf) for m in meshes]  # +1 pad vertex

    def stack(arrays, dtype=None):
        return torch.from_numpy(np.stack(arrays, dtype=dtype)).to(device)

    return RenderAssets(
        lod=lod,
        vertices=stack([p.vertices for p in padded]),
        faces=stack([p.faces for p in padded]),
        colors=stack([p.colors for p in padded]),
        normals=stack([p.normals for p in padded]),
        corners=stack([model_corners(m.vertices.min(0), m.vertices.max(0)).numpy()
                       for m in meshes], np.float32),
        points=stack([sample_points(m, num_points) for m in meshes]),
        sym_poses=stack([sym_set(s, ms) for s in sym_transforms]),
        diameters=stack([m.diameter for m in meshes], np.float32),
        tri_pos=stack([p.vertices[p.faces].reshape(-1, 9).T for p in padded]),
        tri_col=stack([p.colors[p.faces].reshape(-1, 9).T for p in padded]),
        tri_nrm=stack([p.normals[p.faces].reshape(-1, 9).T for p in padded]),
        sym_continuous=torch.from_numpy(sym_cont).to(device),
        cull_dir=stack([cull_direction(m) for m in meshes], np.float32),
    )


def gather_class(assets: RenderAssets, class_idx: torch.Tensor) -> RenderAssets:
    """Per-sample asset views: class axis C -> batch axis B.

    ``lod`` is left as it is (the refine loop gathers the coarse level
    itself).
    """
    idx = class_idx.long()
    return assets._replace(**{
        f: None if a is None else a.index_select(0, idx.to(a.device))
        for f, a in zip(assets._fields, assets)
        if f != "lod"
    })


@torch.no_grad()
def render_crops(assets_b: RenderAssets, poses: torch.Tensor, ks: torch.Tensor,
                 out_size: tuple[int, int],
                 lighting: Lighting = FLAT_LIGHTING) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize each hypothesis at crop resolution -> rgb (B,H,W,3), depth.

    Crop-regime dispatch as in the reference: the cols kernel from
    ``_COLS_MIN_FACES_CROP`` faces up, else the sorted kernel with spans
    (8, 3) (faces fill the frame, so they bin to their exact tiles).
    """
    binning = ("cols" if assets_b.tri_pos.shape[2] >= raster_cuda._COLS_MIN_FACES_CROP
               else "sort")
    return raster_cuda.render_batch_tri(
        assets_b.tri_pos, assets_b.tri_col, assets_b.tri_nrm, poses, ks,
        out_size, lighting=lighting, binning=binning, spans=(8, 3),
        cull_dir=assets_b.cull_dir)


class RefineStepOutputs(NamedTuple):
    pose: torch.Tensor  # (B, 3, 4) updated pose
    k_zoom: torch.Tensor  # (B, 3, 3) crop intrinsics used this step


class NetworkInputs(NamedTuple):
    x: torch.Tensor  # (B, H, W, 6+) assembled CNN input (NHWC)
    box: ZoomBox  # (B,)-shaped fields
    k_zoom: torch.Tensor  # (B, 3, 3) crop intrinsics
    ren_rgb: torch.Tensor  # (B, H, W, 3) rendered crop
    ren_depth: torch.Tensor  # (B, H, W) rendered depth crop


@torch.no_grad()
def build_network_inputs(model, assets_b: RenderAssets, obs_rgb: torch.Tensor,
                         pose: torch.Tensor, k: torch.Tensor,
                         out_size: tuple[int, int], zoom_margin: float = 1.4,
                         obs_mask: torch.Tensor | None = None,
                         obs_depth: torch.Tensor | None = None) -> NetworkInputs:
    """Render -> zoom -> concat assembly of the CNN input.

    A missing observed mask/depth falls back to the rendered silhouette or
    depth, as in the reference.
    """
    box = compute_zoom_box(pose, k, assets_b.corners, out_size, zoom_margin)
    k_zoom = zoom_intrinsics(k, box)
    ren_rgb, ren_depth = render_crops(assets_b, pose, k_zoom, out_size)
    obs_crop = zoom_image_batch(obs_rgb, box, out_size)

    extras = ()
    if getattr(model, "input_mask", False):
        ren_mask = (ren_depth > 0).to(torch.float32)[..., None]
        if obs_mask is not None:
            obs_mask_in = zoom_image_batch(obs_mask[..., None].to(torch.float32),
                                           box, out_size, method="nearest")
        else:
            obs_mask_in = ren_mask
        extras = (ren_mask, obs_mask_in)
    if getattr(model, "input_depth", False):
        z_src = pose[:, 2, 3]
        if obs_depth is not None:
            obs_depth_in = zoom_image_batch(obs_depth[..., None], box, out_size,
                                            method="nearest")[..., 0]
        else:
            obs_depth_in = ren_depth
        extras = (*extras, normalize_depth(ren_depth, z_src),
                  normalize_depth(obs_depth_in, z_src))
    return NetworkInputs(network_input(obs_crop, ren_rgb, extras), box, k_zoom,
                         ren_rgb, ren_depth)


@torch.no_grad()
def refine_step(model, assets_b: RenderAssets, obs_rgb: torch.Tensor,
                pose: torch.Tensor, k: torch.Tensor, class_idx: torch.Tensor,
                out_size: tuple[int, int], zoom_margin: float = 1.4,
                obs_mask: torch.Tensor | None = None,
                obs_depth: torch.Tensor | None = None) -> RefineStepOutputs:
    """One render -> zoom -> CNN -> compose update."""
    ni = build_network_inputs(model, assets_b, obs_rgb, pose, k, out_size,
                              zoom_margin, obs_mask=obs_mask, obs_depth=obs_depth)
    out = model(ni.x)
    quat = decode_rot(select_class(out["rot_raw"], class_idx), model.rot_type)
    trans = select_class(out["trans"], class_idx)
    clip = torch.tensor(_TRANS_CLIP, dtype=trans.dtype, device=trans.device)
    trans = trans.clamp(-clip, clip)
    return RefineStepOutputs(apply_delta(pose, DeltaPose(quat, trans), ni.k_zoom),
                             ni.k_zoom)


@torch.no_grad()
def refine_poses(model, assets: RenderAssets, obs_rgb: torch.Tensor,
                 init_pose: torch.Tensor, k: torch.Tensor, class_idx: torch.Tensor,
                 num_iters: int = 4, out_size: tuple[int, int] = (480, 640),
                 zoom_margin: float = 1.4, return_all: bool = False,
                 obs_mask: torch.Tensor | None = None,
                 obs_depth: torch.Tensor | None = None,
                 coarse_iters: int = 0,
                 coarse_size: tuple[int, int] | None = None) -> torch.Tensor:
    """K-iteration refinement -> (B, 3, 4), or (num_iters+1, B, 3, 4) with
    ``return_all`` (the initial pose first).

    ``coarse_iters`` > 0 runs the first that many iterations at
    ``coarse_size`` (default half of ``out_size``), rendering the coarse
    ``assets.lod`` when there is one; the model needs a ``head_grid``.
    """
    assets_b = gather_class(assets, class_idx)
    coarse_iters = min(coarse_iters, num_iters)
    if coarse_iters > 0 and getattr(model, "head_grid", None) is None:
        raise ValueError(
            "coarse_iters > 0 needs one pose head shared across resolutions: "
            "build the model with head_grid=bottleneck_grid(H, W)")
    c_size = coarse_size or (out_size[0] // 2, out_size[1] // 2)
    ab_coarse = (gather_class(assets.lod, class_idx)
                 if coarse_iters and assets.lod is not None else assets_b)
    pose = init_pose
    trajs = [init_pose]
    for it in range(num_iters):
        coarse = it < coarse_iters
        pose = refine_step(model, ab_coarse if coarse else assets_b, obs_rgb,
                           pose, k, class_idx, c_size if coarse else out_size,
                           zoom_margin, obs_mask=obs_mask, obs_depth=obs_depth).pose
        trajs.append(pose)
    return torch.stack(trajs) if return_all else pose
