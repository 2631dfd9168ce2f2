"""Visual demo: renders, overlays and the flow ground truth's colour wheel
-> PNG images.

Port of ``tools/demo_render.py``: four procedural objects rendered at
poses drawn in the LINEMOD camera (``objects.png``), a perturbed pose's
render over the GT render (``overlay_init_vs_observed.png``), the flow GT
between the two (``flow_gt.png``), the four objects as one scene
(``scene.png``) and a checkered box through the deferred-texture pass
(``textured.png``).  The renders run on ``--device`` (the CUDA kernels on
the card, the plain versions on the CPU); draws come from torch
generators seeded 0 and 1, as the reference's keys are 0 and 1.

Usage: python -m deepim_tpu_torch.tools.demo_render [out_dir] [--device cuda:0]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default="output/demo")
    p.add_argument("--device", default="cuda:0",
                   help="torch device (default cuda:0; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from deepim_tpu_torch.cli.train import _device
    from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
    from deepim_tpu_torch.ops.flow_gt import calc_flow
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.raster.mesh import (
        Mesh, box_mesh, compute_vertex_normals, cylinder_mesh, icosphere_mesh, torus_mesh)
    from deepim_tpu_torch.raster.textured import render_batch_textured, tri_uv_corner_major
    from deepim_tpu_torch.refine import build_assets, gather_class
    from deepim_tpu_torch.refine.refiner import render_crops, render_scene
    from deepim_tpu_torch.utils import flow_to_rgb, overlay_render, save_image, side_by_side

    dev = _device(args.device)
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    size = (480, 640)

    def u8(x) -> np.ndarray:
        return (np.clip(x.cpu().numpy(), 0, 1) * 255).astype(np.uint8)

    assets = build_assets([box_mesh((0.08, 0.1, 0.06)), icosphere_mesh(0.05, subdivisions=3),
                           cylinder_mesh(), torus_mesh()], num_points=64, device=dev)
    k = make_intrinsics(572.4, 573.6, 325.3, 242.0, device=dev)
    poses = sample_poses_in_frustum(torch.Generator(device=dev).manual_seed(0), 4, k, size,
                                    z_range=(0.6, 0.8))
    cls = torch.arange(4, device=dev)
    ks = k.expand(4, 3, 3).contiguous()
    ab = gather_class(assets, cls)
    rgb, depth = render_crops(ab, poses, ks, size)
    save_image(os.path.join(out_dir, "objects.png"), side_by_side(*[u8(rgb[i]) for i in range(4)]))

    # overlay: a perturbed pose's render over the "observed" GT render
    noisy = perturb_poses(torch.Generator(device=dev).manual_seed(1), poses)
    rgb_n, depth_n = render_crops(ab, noisy, ks, size)
    save_image(os.path.join(out_dir, "overlay_init_vs_observed.png"),
               overlay_render(rgb[0].cpu().numpy(), rgb_n[0].cpu().numpy(),
                              depth_n[0].cpu().numpy()))

    # flow GT colour wheel between the two poses
    flow, _ = calc_flow(depth_n[:1], noisy[:1], poses[:1], k[None], depth[:1])
    save_image(os.path.join(out_dir, "flow_gt.png"), flow_to_rgb(flow[0].cpu().numpy()))

    # multi-object scene
    srgb, _ = render_scene(assets, cls[None], poses[None],
                           torch.ones((1, 4), dtype=torch.bool, device=dev), ks[:1], size)
    save_image(os.path.join(out_dir, "scene.png"), u8(srgb[0]))

    # per-pixel texture sampling (the deferred UV pass) on a checkered box
    bm = box_mesh((0.1, 0.1, 0.1))
    uv = (bm.vertices[:, :2] / 0.1 + 1.0) / 2.0  # unwrapped by vertex xy
    tm = Mesh(bm.vertices, bm.faces, bm.colors, compute_vertex_normals(bm.vertices, bm.faces),
              uv=uv.astype(np.float32))
    checker = ((np.indices((64, 64)).sum(0) // 8) % 2).astype(np.float32)
    tex = np.stack([checker, 1 - checker, np.full_like(checker, 0.5)], -1)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    trgb, _ = render_batch_textured(
        t(tm.vertices[tm.faces].reshape(-1, 9).T)[None], t(tri_uv_corner_major(tm))[None],
        t(tm.normals[tm.faces].reshape(-1, 9).T)[None], poses[:1], ks[:1], size, t(tex))
    save_image(os.path.join(out_dir, "textured.png"), u8(trgb[0]))
    print(f"wrote demo images to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
