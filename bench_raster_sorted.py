#!/usr/bin/env python3
"""Time the sorted raster kernel at the shapes the port's main paths give it.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 bench_raster_sorted.py [--tree DIR] [--e2e N]

``--tree DIR`` takes ``deepim_tpu_torch`` from another checkout (say, the
parent commit unpacked into a directory that ``.gitignore`` lists), so
two versions of the kernel are timed on one card: run them in turns
(parent, change, change, parent) in one command.  Each run builds the
kernels of its tree.  The inputs come from that tree's packing and
binning, at B=128:

- ``sort_route`` 480x640 and 240x320: ``render_crops``' sort route
  (spans (8, 3)) on the headline classes with the sphere under 1,024
  faces;
- ``sort_route_lod`` 240x320: the same route on the decimated level of the
  classes padded to 4,096 faces (their coarse iterations);
- ``fallback_binning`` 480x640 and 240x320: the cols path's lossless
  fallback (spans over the whole tile grid) on the headline's crops;
- ``synthesis_untextured`` / ``synthesis_textured``: the scene render of
  ``synthetic_occlusion_batch`` (3,840 faces, 480x640, LINEMOD K).

Each case prints one JSON line: its ms per call (CUDA events, 20 calls
after a warm one, L2 left warm as between the main path's calls).  The
first line is the card's name and power limit.  ``chip_smoke.py`` holds
the kernel against its plain version; this script only times it.

``--e2e N`` times the two calls whose device work the sorted kernel
carries instead, N times each after a warm call (host clock, each ending
in a synchronize): untextured ``synthetic_occlusion_batch`` and
``refine_poses`` on the sort-route assets (the headline protocol, bf16,
random weights); it prints the median and quartiles of each.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

import chip_smoke  # its helpers import the port only inside their bodies

REPS = 20


def cases(dev):
    """(case, size, args) of every sorted-kernel call to time."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data import synthetic_occlusion_batch
    from deepim_tpu_torch.ops.zoom import compute_zoom_box, zoom_intrinsics
    from deepim_tpu_torch.raster import raster_cuda as rc
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.refine import build_assets, gather_class

    assets = hl.headline_assets(dev)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, hl.B)
    lod = build_assets(chip_smoke.dense_meshes(), sym_transforms=hl.headline_meshes()[1],
                       num_points=300, lod_faces=hl.LOD_FACES, device=dev).lod
    out = []
    for name, a, sizes in (("sort_route", hl.headline_assets(dev, dense_sphere=False),
                            (hl.SIZE, hl.COARSE)),
                           ("sort_route_lod", lod, (hl.COARSE,)),
                           ("fallback_binning", assets, (hl.SIZE, hl.COARSE))):
        ab = gather_class(a, cls)
        for h, w in sizes:
            kz = zoom_intrinsics(ks, compute_zoom_box(init, ks, ab.corners, (h, w)))
            params, bbox, ok = rc.pack_tri_params(ab.tri_pos, ab.tri_col, ab.tri_nrm, init,
                                                  kz, rc.FLAT_LIGHTING, 0.01, ab.cull_dir)
            spans = (8, 3) if name != "fallback_binning" else (-(-h // 32), -(-w // 256))
            out.append((name, (h, w), (params, *rc.bin_faces_sorted(bbox, ok, (h, w), *spans),
                                       h, w)))
    k = make_intrinsics(*hl.LINEMOD_K, device=dev)
    for name, a in (("synthesis_untextured", assets),
                    ("synthesis_textured", hl.headline_assets(dev, textured=True))):
        with chip_smoke.captured_inputs(rc) as calls:
            synthetic_occlusion_batch(torch.Generator(device=dev).manual_seed(hl.SEED), a,
                                      hl.B, k, hl.SIZE, num_distractors=2)
        args = next(c[1] for c in calls if c[0] == "raster_sorted")
        out.append((name, hl.SIZE, args))
    return out


def e2e(dev, n: int) -> dict:
    """Wall ms per call (median, quartiles over n) of untextured synthesis
    and of sort-route refine_poses."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data import synthetic_occlusion_batch
    from deepim_tpu_torch.raster.camera import make_intrinsics

    assets = hl.headline_assets(dev)
    sort_assets = hl.headline_assets(dev, dense_sphere=False)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, hl.B)
    model = hl.random_model(assets.num_classes).to(dev)
    k = make_intrinsics(*hl.LINEMOD_K, device=dev)
    calls = {
        "synthesis_untextured": lambda: synthetic_occlusion_batch(
            torch.Generator(device=dev).manual_seed(hl.SEED), assets, hl.B, k, hl.SIZE,
            num_distractors=2),
        "refine_poses_sort_route": lambda: hl.run_headline(model, sort_assets, obs, init,
                                                           ks, cls),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = statistics.quantiles(times, n=4)
        out[name] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3, "calls": n}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=chip_smoke.ROOT,
                    help="checkout whose deepim_tpu_torch is timed")
    ap.add_argument("--e2e", type=int, default=0, metavar="N",
                    help="time N end-to-end calls of each main path instead")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_raster_sorted: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opts.tree.resolve()))
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.raster import _build
    from deepim_tpu_torch.raster import raster_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(hl.card(), flush=True)
    info = _build.build()
    ptxas = chip_smoke.ptxas_summary(info.log).get("raster_sorted_kernel",
                                                   "no nvcc log: an earlier run's build")
    dev = torch.device("cuda", 0)
    if opts.e2e:
        print(json.dumps({"tree": str(opts.tree), "e2e": e2e(dev, opts.e2e)}), flush=True)
        return 0
    for name, (h, w), args in cases(dev):
        rc.raster_sorted(*args)  # warm
        ms = chip_smoke.ms_per_call(lambda: rc.raster_sorted(*args), REPS)
        print(json.dumps({"tree": str(opts.tree), "case": name, "size": f"{h}x{w}",
                          "batch": args[0].shape[0], "faces": args[0].shape[1],
                          "ms": ms, "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
