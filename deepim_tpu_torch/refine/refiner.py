"""The iterative render-and-compare refinement loop (torch).

Port of ``deepim_tpu/refine/refiner.py``: ``RenderAssets``/``build_assets``
(with the nested coarse ``lod``, ``cull_dir`` and the texture atlas),
``gather_class``, ``render_crops`` with its crop-regime kernel dispatch and
its textured branch, the multi-object ``render_scene``,
``build_network_inputs``, ``refine_step`` and ``refine_poses`` (with
``coarse_iters``/``coarse_size`` and ``return_all``).  The reference's
``lax.scan`` over iterations is a Python loop here; everything is batched
over the hypothesis axis B and runs on the device of the inputs.
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
from deepim_tpu_torch.raster.textured import (
    _map_batch_chunks,
    pack_tri_params_uv,
    render_batch_textured,
    sample_texture_bilinear,
)
from deepim_tpu_torch.utils.profiling import stage

# Bound on one iteration's update: |vx|, |vy| <= 2000 crop px, |vz| <= 4.
_TRANS_CLIP = (2000.0, 2000.0, 4.0)


class RenderAssets(NamedTuple):
    """Per-class mesh data stacked to shared budgets (leading class axis C).

    ``tri_*`` are corner-major (C, 9, F): row 3*corner+coord holds that
    component for all F faces, gathered once at build time.  Textured sets
    carry the atlas: ``tri_uv`` rescaled into it, ``textures`` (one padded
    canvas per class) and ``tex_idx``, the class's canvas; ``gather_class``
    maps ``tex_idx`` to the batch but leaves ``textures`` (and ``lod``,
    which shares the parent's atlas) with their class axis.
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
    tri_uv: torch.Tensor | None = None  # (C, 6, F) corner UVs in the atlas frame
    textures: torch.Tensor | None = None  # (C, Th, Tw, 3) padded canvases
    tex_idx: torch.Tensor | None = None  # (C,) -> per-sample (B,) after gather
    sym_continuous: torch.Tensor | None = None  # (C,) bool
    cull_dir: torch.Tensor | None = None  # (C,) ±1 back-face cull sign, 0 = off
    lod: Any = None  # coarse RenderAssets for coarse iterations, or None

    @property
    def num_classes(self) -> int:
        return self.vertices.shape[0]

    @property
    def textured(self) -> bool:
        return self.textures is not None

    def to(self, device) -> "RenderAssets":
        """The same assets on ``device`` (the nested ``lod`` too)."""
        return RenderAssets(*(
            None if a is None else a.to(device) for a in self))


def build_assets(meshes, sym_transforms=None, num_points: int = 3000,
                 use_textures: bool | None = None, lod_faces: int | None = None,
                 device: torch.device | str = "cuda") -> RenderAssets:
    """Stack host meshes into a RenderAssets on ``device``, padded to the
    set's largest vertex, face and symmetry counts.

    ``use_textures``: None turns per-pixel texturing on when any mesh has a
    texture; False bakes vertex colours only; True requires a textured
    mesh.  ``lod_faces`` builds the nested coarse level (every mesh
    decimated to that face budget) only when it at least halves the face
    table, as the reference does; it shares the parent's atlas.
    """
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
                           num_points=min(num_points, 16), use_textures=use_textures,
                           device=device)
    padded = [pad_mesh(m, mv + 1, mf) for m in meshes]  # +1 pad vertex

    def stack(arrays, dtype=None):
        return torch.from_numpy(np.stack(arrays, dtype=dtype)).to(device)

    tex = {k: torch.from_numpy(v).to(device)
           for k, v in _texture_fields(meshes, padded, use_textures).items()}
    if lod is not None and tex:
        # The same images make the same canvases: share the parent's atlas.
        lod = lod._replace(textures=tex["textures"], tex_idx=tex["tex_idx"])
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
        **tex,
    )


def _texture_fields(meshes, padded, use_textures) -> dict[str, np.ndarray]:
    """The atlas fields (tri_uv, textures, tex_idx) of a textured set, as numpy.

    Each texture lands at the top-left of a (max Th, max Tw) canvas and the
    mesh UVs are rescaled so that the sampler's x = u*(W-1), y = (1-v)*(H-1)
    hits the same texels as before padding.  A mesh with a texture but no
    UVs gets a flat canvas of the texture's mean, an untextured mesh one of
    its mean vertex colour.
    """
    have = any(m.texture is not None for m in meshes)
    if use_textures is None:
        use_textures = have
    if not use_textures:
        return {}
    if not have:
        raise ValueError("use_textures=True but no mesh has a texture")

    texs = []
    for m in meshes:
        if m.texture is not None and m.uv is not None:
            texs.append(np.asarray(m.texture[..., :3], np.float32))
        elif m.texture is not None:
            mean = np.asarray(m.texture[..., :3], np.float32).mean((0, 1))
            texs.append(np.broadcast_to(mean, (2, 2, 3)).copy())
        else:
            mean = m.colors.mean(0).astype(np.float32)
            texs.append(np.broadcast_to(mean, (2, 2, 3)).copy())
    th = max(t.shape[0] for t in texs)
    tw = max(t.shape[1] for t in texs)
    canvas, uvs = [], []
    for m, p, t in zip(meshes, padded, texs):
        c = np.zeros((th, tw, 3), np.float32)
        c[: t.shape[0], : t.shape[1]] = t
        canvas.append(c)
        if m.uv is not None and m.texture is not None:
            uv = np.concatenate(
                [m.uv, np.zeros((p.num_vertices - m.num_vertices, 2), np.float32)])
        else:
            uv = np.full((p.num_vertices, 2), 0.5, np.float32)
        su = (t.shape[1] - 1) / max(tw - 1, 1)
        sv = (t.shape[0] - 1) / max(th - 1, 1)
        uv = np.stack([uv[:, 0] * su, 1.0 - (1.0 - uv[:, 1]) * sv], 1)
        uvs.append(uv[p.faces].reshape(-1, 6).T.copy())
    return {
        "tri_uv": np.stack(uvs),
        "textures": np.stack(canvas),
        "tex_idx": np.arange(len(meshes), dtype=np.int32),
    }


def gather_class(assets: RenderAssets, class_idx: torch.Tensor) -> RenderAssets:
    """Per-sample asset views: class axis C -> batch axis B.

    ``textures`` keeps its class axis (the deferred pass indexes the atlas
    by ``tex_idx``); ``lod`` is left as it is (the refine loop gathers the
    coarse level itself).
    """
    idx = class_idx.long()
    return assets._replace(**{
        f: None if a is None else a.index_select(0, idx.to(a.device))
        for f, a in zip(assets._fields, assets)
        if f not in ("textures", "lod")
    })


@torch.no_grad()
def render_crops(assets_b: RenderAssets, poses: torch.Tensor, ks: torch.Tensor,
                 out_size: tuple[int, int],
                 lighting: Lighting = FLAT_LIGHTING) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize each hypothesis at crop resolution -> rgb (B,H,W,3), depth.

    Crop-regime dispatch as in the reference: the cols kernel from
    ``_COLS_MIN_FACES_CROP`` faces up, else the sorted kernel with spans
    (8, 3) (faces fill the frame, so they bin to their exact tiles).
    Textured sets take the same routes through the deferred-texture pass.
    """
    binning = ("cols" if assets_b.tri_pos.shape[2] >= raster_cuda._COLS_MIN_FACES_CROP
               else "sort")
    if assets_b.textured:
        return render_batch_textured(
            assets_b.tri_pos, assets_b.tri_uv, assets_b.tri_nrm, poses, ks, out_size,
            assets_b.textures, lighting=lighting, binning=binning,
            tex_idx=assets_b.tex_idx, spans=(8, 3), cull_dir=assets_b.cull_dir)
    return raster_cuda.render_batch_tri(
        assets_b.tri_pos, assets_b.tri_col, assets_b.tri_nrm, poses, ks,
        out_size, lighting=lighting, binning=binning, spans=(8, 3),
        cull_dir=assets_b.cull_dir)


@torch.no_grad()
def render_scene(assets: RenderAssets, class_idx: torch.Tensor, poses: torch.Tensor,
                 valid: torch.Tensor, ks: torch.Tensor, out_size: tuple[int, int],
                 lighting: Lighting = FLAT_LIGHTING) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-object scene render with a shared z-buffer -> rgb (B,H,W,3), depth.

    ``class_idx`` (B, M) class per scene slot, ``poses`` (B, M, 3, 4),
    ``valid`` (B, M) bool (inactive slots render nothing), ``ks`` (B, 3, 3).
    Each slot's mesh is packed at its own pose, the slots' faces are
    concatenated slot-major into one (B, M*F) face table, and one "auto"
    raster dispatch (spans (4, 2); face chunks past ``_FACE_CHUNK``)
    z-tests everything, so objects occlude each other.

    Textured sets remap each slot's v into its class's band of the
    vertically stacked (C*Th, Tw) atlas, so one deferred bilinear pass
    serves every object: at an integer band-edge row the next row's tap
    has zero weight, so textures never bleed across bands.  Background
    keeps intensity 0, so its rgb is 0 without a depth mask.
    """
    b, m = class_idx.shape
    flat_cls = class_idx.reshape(-1).long()

    def take(a):
        return a.index_select(0, flat_cls.to(a.device))

    with stage("render"):
        with stage("render.pack"):
            tri_pos, tri_nrm = take(assets.tri_pos), take(assets.tri_nrm)
            poses_f = poses.reshape(-1, 3, 4)
            ks_f = ks.repeat_interleave(m, dim=0)
            cull_f = (take(assets.cull_dir) if assets.cull_dir is not None
                      else torch.zeros(b * m, dtype=torch.float32, device=tri_pos.device))
            if assets.textured:
                th = assets.textures.shape[1]
                h_all = assets.textures.shape[0] * th
                tidx = take(assets.tex_idx) if assets.tex_idx is not None else flat_cls
                tri_uv = take(assets.tri_uv)  # (B*M, 6, F), a fresh copy
                # v' puts the sample row y = (1-v)*(Th-1) into band tidx of the
                # stacked atlas (sampler convention y = (1-v')*(H_all-1)).
                y_band = (tidx.to(torch.float32)[:, None, None] * th
                          + (1.0 - tri_uv[:, 1::2, :]) * (th - 1))
                tri_uv[:, 1::2, :] = 1.0 - y_band / max(h_all - 1, 1)
                params, bbox, face_ok = pack_tri_params_uv(tri_pos, tri_uv, tri_nrm, poses_f,
                                                           ks_f, lighting, 0.01, cull_f)
            else:
                params, bbox, face_ok = raster_cuda.pack_tri_params(
                    tri_pos, take(assets.tri_col), tri_nrm, poses_f, ks_f, lighting, 0.01,
                    cull_f)
            face_ok = face_ok & valid.reshape(-1)[:, None]
        f = params.shape[1]
        out, depth = raster_cuda._render_dispatch(
            params.reshape(b, m * f, 24), bbox.reshape(b, m * f, 4),
            face_ok.reshape(b, m * f), out_size, "auto")
        if assets.textured:
            stacked = assets.textures.reshape(h_all, assets.textures.shape[2], 3)
            albedo = _map_batch_chunks(
                lambda uu, vv: sample_texture_bilinear(stacked, uu, vv), 16,
                out[..., 0], out[..., 1])
            out = (albedo * out[..., 2:3]).clamp(0.0, 1.0)
    return out, depth


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
    depth, as in the reference.  Spans: ``zoom.box`` (the box and the crop
    intrinsics), ``render``, ``zoom.image`` (the observed crops),
    ``network.input`` (masks, depth normalisation and the concat).
    """
    with_mask = getattr(model, "input_mask", False)
    with_depth = getattr(model, "input_depth", False)
    with stage("zoom.box"):
        box = compute_zoom_box(pose, k, assets_b.corners, out_size, zoom_margin)
        k_zoom = zoom_intrinsics(k, box)
    ren_rgb, ren_depth = render_crops(assets_b, pose, k_zoom, out_size)
    with stage("zoom.image"):
        obs_crop = zoom_image_batch(obs_rgb, box, out_size)
        obs_mask_in = obs_depth_in = None
        if with_mask and obs_mask is not None:
            obs_mask_in = zoom_image_batch(obs_mask[..., None].to(torch.float32),
                                           box, out_size, method="nearest")
        if with_depth and obs_depth is not None:
            obs_depth_in = zoom_image_batch(obs_depth[..., None], box, out_size,
                                            method="nearest")[..., 0]
    with stage("network.input"):
        extras = ()
        if with_mask:
            ren_mask = (ren_depth > 0).to(torch.float32)[..., None]
            extras = (ren_mask, ren_mask if obs_mask_in is None else obs_mask_in)
        if with_depth:
            z_src = pose[:, 2, 3]
            extras = (*extras, normalize_depth(ren_depth, z_src),
                      normalize_depth(ren_depth if obs_depth_in is None else obs_depth_in,
                                      z_src))
        x = network_input(obs_crop, ren_rgb, extras)
    return NetworkInputs(x, box, k_zoom, ren_rgb, ren_depth)


@torch.no_grad()
def refine_step(model, assets_b: RenderAssets, obs_rgb: torch.Tensor,
                pose: torch.Tensor, k: torch.Tensor, class_idx: torch.Tensor,
                out_size: tuple[int, int], zoom_margin: float = 1.4,
                obs_mask: torch.Tensor | None = None,
                obs_depth: torch.Tensor | None = None) -> RefineStepOutputs:
    """One render -> zoom -> CNN -> compose update.  The network runs pose
    only: a training model's flow decoder and mask head are skipped."""
    ni = build_network_inputs(model, assets_b, obs_rgb, pose, k, out_size,
                              zoom_margin, obs_mask=obs_mask, obs_depth=obs_depth)
    with stage("network.forward"):
        out = model(ni.x, pose_only=True)
    with stage("refine.compose"):
        quat = decode_rot(select_class(out["rot_raw"], class_idx), model.rot_type)
        trans = select_class(out["trans"], class_idx)
        clip = torch.tensor(_TRANS_CLIP, dtype=trans.dtype, device=trans.device)
        trans = trans.clamp(-clip, clip)
        pose = apply_delta(pose, DeltaPose(quat, trans), ni.k_zoom)
    return RefineStepOutputs(pose, ni.k_zoom)


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
    Spans: ``refine_poses`` (batch, iters), and a ``refine.iter`` (it,
    coarse, size) an iteration.
    """
    coarse_iters = min(coarse_iters, num_iters)
    if coarse_iters > 0 and getattr(model, "head_grid", None) is None:
        raise ValueError(
            "coarse_iters > 0 needs one pose head shared across resolutions: "
            "build the model with head_grid=bottleneck_grid(H, W)")
    c_size = coarse_size or (out_size[0] // 2, out_size[1] // 2)
    with stage("refine_poses", batch=init_pose.shape[0], iters=num_iters):
        assets_b = gather_class(assets, class_idx)
        ab_coarse = (gather_class(assets.lod, class_idx)
                     if coarse_iters and assets.lod is not None else assets_b)
        pose = init_pose
        trajs = [init_pose]
        for it in range(num_iters):
            coarse = it < coarse_iters
            size = c_size if coarse else out_size
            with stage("refine.iter", it=it, coarse=coarse, size=size):
                pose = refine_step(model, ab_coarse if coarse else assets_b, obs_rgb,
                                   pose, k, class_idx, size, zoom_margin,
                                   obs_mask=obs_mask, obs_depth=obs_depth).pose
            trajs.append(pose)
        return torch.stack(trajs) if return_all else pose
