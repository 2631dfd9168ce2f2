"""Is decimated-mesh RENDERING accuracy-neutral?

Real scanned meshes (YCB: 100k+ faces) are decimated to
``dataset.max_faces`` (default 4096) before they reach the rasterizer;
the pose-error METRIC always uses points sampled from the full-res mesh.
This tool measures what the render-side decimation costs in accuracy:
observations are rendered from FULL-resolution meshes, refinement runs
with assets decimated to each face budget, and both are evaluated with
the same full-mesh metric points.

    python -m deepim_tpu_torch.tools.decimation_ab --cfg experiments/cfgs/<exp>.yaml \
        [--budgets 1024,4096,0] [--samples 2048] [--device cuda:0]

Budget 0 = no decimation (the full-res reference row).  Requires a
trained port checkpoint for the config (the refiner must actually move
poses for the delta to mean anything).  Port of ``tools/decimation_ab.py``:
its arguments, table and ``--results-out`` record; observation batch ``i``
is :func:`~deepim_tpu_torch.data.synthetic_batch` from a
``torch.Generator`` on the device seeded ``52000 + i``.  The subdivision-5
stand-ins have 20,480 faces, so their decimation runs in the port's C++
(``mesh._NATIVE_MIN_FACES``).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="render-side decimation accuracy A/B")
    p.add_argument("--cfg", required=True)
    p.add_argument("--budgets", default="1024,4096,0",
                   help="comma list of face budgets (0 = full resolution)")
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--subdiv", type=int, default=5,
                   help="icosphere subdivisions for the dense stand-in "
                        "meshes (5 -> ~20k faces, the scanned-mesh regime)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override cfg.test.batch_size (CPU smoke)")
    p.add_argument("--lod-faces", type=int, default=0,
                   help="also build the coarse LOD level at this budget "
                        "for every budget row (validates the product "
                        "default dataset.lod_faces: coarse iterations "
                        "render the LOD level)")
    p.add_argument("--coarse-iters", type=int, default=-1,
                   help="override cfg.test.coarse_iters (-1 = config)")
    p.add_argument("--results-out", default="",
                   help="write the table to this JSON (committed results/ tree)")
    p.add_argument("--device", default="cuda:0",
                   help="torch device (default cuda:0; 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from deepim_tpu_torch.cli.train import _device
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.data.synthetic import synthetic_batch
    from deepim_tpu_torch.eval import evaluate_poses
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.raster.mesh import (
        cylinder_mesh, decimate_mesh, icosphere_mesh, torus_mesh)
    from deepim_tpu_torch.refine import build_assets, refine_poses
    from deepim_tpu_torch.tools import restored_model

    cfg = update_config(args.cfg)
    dev = _device(args.device)
    # Dense stand-ins for scanned assets (~10-20k faces each).  The
    # checkpoint's class count must match the config's objects; reuse its
    # class slots with same-symmetry dense shapes.
    dense = [
        icosphere_mesh(0.06, subdivisions=args.subdiv),
        icosphere_mesh(0.05, subdivisions=args.subdiv),
        torus_mesh(n_major=96, n_minor=48),
        cylinder_mesh(segments=256, rows=16),
    ][: len(cfg.dataset.objects)]
    while len(dense) < len(cfg.dataset.objects):
        dense.append(icosphere_mesh(0.05 + 0.01 * len(dense), subdivisions=args.subdiv))
    print("dense meshes:", [int(m.faces.shape[0]) for m in dense])

    full_assets = build_assets(dense, num_points=cfg.dataset.num_points, device=dev)
    model, step = restored_model(cfg, len(cfg.dataset.objects), dev)

    d, t = cfg.dataset, cfg.train
    k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
    image_size = (d.image_height, d.image_width)
    out_size = (cfg.network.input_height, cfg.network.input_width)
    bs = args.batch_size or cfg.test.batch_size
    n = max(bs, (args.samples // bs) * bs)
    names = [f"dense_{i}" for i in range(len(dense))]
    sym = [False] * len(dense)

    # Observations: rendered ONCE from the full-res meshes.
    obs_batches = []
    for i in range(n // bs):
        b = synthetic_batch(
            torch.Generator(device=dev).manual_seed(52000 + i), full_assets, bs, k_cam,
            image_size, rot_noise_deg=t.rot_noise_deg, rot_max_deg=t.rot_noise_max_deg,
            trans_noise=tuple(t.trans_noise), trans_max=tuple(t.trans_noise_max))
        obs_batches.append({kk: b[kk] for kk in ("obs_rgb", "pose_src", "pose_tgt",
                                                 "class_idx")})

    coarse_iters = args.coarse_iters if args.coarse_iters >= 0 else cfg.test.coarse_iters
    ks = k_cam.expand(bs, 3, 3).contiguous()
    rows = []
    header = f"{'budget':>8} {'faces':>7} {'add(-s)':>9} {'5d5cm':>7} " \
             f"{'proj2d':>7} {'auc':>7} {'mean_rot':>9}"
    print(header)
    print("-" * len(header))
    for budget in [int(x) for x in args.budgets.split(",")]:
        meshes = [decimate_mesh(m, budget) for m in dense] if budget else dense
        assets_b = build_assets(meshes, num_points=d.num_points,
                                lod_faces=args.lod_faces or None, device=dev)
        # metric points from the FULL mesh in every row (pose errors must
        # be comparable across budgets)
        assets_b = assets_b._replace(points=full_assets.points,
                                     diameters=full_assets.diameters)
        est_all = []
        with torch.no_grad():
            for b in obs_batches:
                est_all.append(refine_poses(
                    model, assets_b, b["obs_rgb"], b["pose_src"], ks, b["class_idx"],
                    num_iters=cfg.test.test_iter, out_size=out_size,
                    coarse_iters=coarse_iters))
        est = torch.cat(est_all).cpu().numpy()
        gt = torch.cat([b["pose_tgt"] for b in obs_batches]).cpu().numpy()
        cls = torch.cat([b["class_idx"] for b in obs_batches]).cpu().numpy()
        ks_np = np.tile(k_cam.cpu().numpy()[None], (est.shape[0], 1, 1))
        res = evaluate_poses(full_assets, names, sym, est, gt, cls, ks_np)
        m = res["mean"]
        faces = int(meshes[0].faces.shape[0])
        print(f"{budget or 'full':>8} {faces:>7} "
              f"{m['add(-s)_0.1d']:>9.2f} {m['5deg_5cm']:>7.2f} "
              f"{m['proj2d_5px']:>7.2f} {m['auc_add(-s)']:>7.2f} "
              f"{m['mean_rot_deg']:>9.2f}")
        rows.append({"budget": budget, "faces": faces, "lod_faces": args.lod_faces,
                     "coarse_iters": coarse_iters, "n": int(est.shape[0]), "mean": m})
    if args.results_out:
        from deepim_tpu_torch.utils.results import record_result

        record_result(args.results_out, {"rows": rows, "checkpoint_step": int(step),
                                         "samples": n}, experiment=cfg.experiment, argv=argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
