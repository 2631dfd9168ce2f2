#!/usr/bin/env python3
"""Time a raster kernel at the shapes the port's main paths give it.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 bench_raster.py --kernel {cols,sorted,topk} [--tree DIR] [--e2e N]

``--tree DIR`` takes ``deepim_tpu_torch`` from another checkout (say, the
parent commit unpacked into a directory that ``.gitignore`` lists), so
two versions of a kernel are timed on one card: run them in turns
(parent, change, change, parent) in one command.  Each run builds the
kernels of its tree.  The inputs come from that tree's packing and
binning, at B=128.

``--kernel sorted``:

- ``sort_route`` 480x640 and 240x320: ``render_crops``' sort route
  (spans (8, 3)) on the headline classes with the sphere under 1,024
  faces;
- ``sort_route_lod`` 240x320: the same route on the decimated level of the
  classes padded to 4,096 faces (their coarse iterations);
- ``fallback_binning`` 480x640 and 240x320: the cols path's lossless
  fallback (spans over the whole tile grid) on the headline's crops;
- ``synthesis_untextured`` / ``synthesis_textured``: the scene render of
  ``synthetic_occlusion_batch`` (3,840 faces, 480x640, LINEMOD K).

``--kernel cols``:

- ``cols_route`` 480x640 and 240x320: the headline's crops (1,280 faces);
- ``cols_route_dense`` 480x640: crops of the classes padded to 4,096 faces
  (the fine iterations of real-size assets; their coarse ones take the
  sorted kernel, ``sort_route_lod``);
- ``synthesis_untextured``: the target-only depth of untextured
  ``synthetic_occlusion_batch`` (1,280 faces, 480x640, LINEMOD K);
- ``synthesis_chunked`` calls 0-2: the three launches of the run on
  classes padded to 4,096 faces with 3 distractors (the 12,288-face and
  4,096-face scene chunks, then the 4,096-face target).

``--kernel topk``: ``crop`` and ``full_frame_render_batch`` at 480x640 and
240x320, binned at 512 faces a tile (``chip_smoke.py §topk_cases``).

Each case prints one JSON line: its ms per call (CUDA events, 20 calls
after a warm one, L2 left warm as between the main path's calls).  The
first line is the card's name and power limit.  ``chip_smoke.py`` holds
the kernels against their plain versions; this script only times them.

``--e2e N`` times the calls whose device work the kernels carry instead,
N times each after a warm call (host clock, each ending in a
synchronize): ``refine_poses`` on the headline assets (the cols route)
and on the sort-route assets (the headline protocol, bf16, random
weights), and untextured and chunked ``synthetic_occlusion_batch``; it
prints the median and quartiles of each.
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


def _synthesis_calls(dev, rc, assets, distractors: int, kernel: str):
    """The args of each ``kernel`` call one synthetic_occlusion_batch makes."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data import synthetic_occlusion_batch
    from deepim_tpu_torch.raster.camera import make_intrinsics

    k = make_intrinsics(*hl.LINEMOD_K, device=dev)
    with chip_smoke.captured_inputs(rc) as calls:
        synthetic_occlusion_batch(torch.Generator(device=dev).manual_seed(hl.SEED), assets,
                                  hl.B, k, hl.SIZE, num_distractors=distractors)
    return [c[1] for c in calls if c[0] == kernel]


def sorted_cases(dev, rc):
    """(case, size, args) of every sorted-kernel call to time."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.refine import gather_class

    assets = hl.headline_assets(dev)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, hl.B)
    out = []
    lod = chip_smoke.dense_assets(dev, lod_faces=hl.LOD_FACES).lod
    for name, a, sizes in (("sort_route", hl.headline_assets(dev, dense_sphere=False),
                            (hl.SIZE, hl.COARSE)),
                           ("sort_route_lod", lod, (hl.COARSE,)),
                           ("fallback_binning", assets, (hl.SIZE, hl.COARSE))):
        ab = gather_class(a, cls)
        for h, w in sizes:
            params, bbox, ok = chip_smoke.crop_pack(rc, ab, init, ks, (h, w))
            spans = (8, 3) if name != "fallback_binning" else (-(-h // 32), -(-w // 256))
            out.append((name, (h, w), (params, *rc.bin_faces_sorted(bbox, ok, (h, w), *spans),
                                       h, w)))
    for name, a in (("synthesis_untextured", assets),
                    ("synthesis_textured", hl.headline_assets(dev, textured=True))):
        out.append((name, hl.SIZE, _synthesis_calls(dev, rc, a, 2, "raster_sorted")[0]))
    return out


def cols_cases(dev, rc):
    """(case, size, args) of every cols-kernel call to time."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.refine import gather_class

    assets = hl.headline_assets(dev)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, hl.B)
    ab = gather_class(assets, cls)
    out = []
    for h, w in (hl.SIZE, hl.COARSE):
        params, bbox, ok = chip_smoke.crop_pack(rc, ab, init, ks, (h, w))
        out.append(("cols_route", (h, w),
                    (params, *rc.bin_faces_packed(bbox, ok, (h, w)), h, w)))
    dense = chip_smoke.dense_assets(dev)
    params, bbox, ok = chip_smoke.crop_pack(rc, gather_class(dense, cls), init, ks, hl.SIZE)
    out.append(("cols_route_dense", hl.SIZE,
                (params, *rc.bin_faces_packed(bbox, ok, hl.SIZE), *hl.SIZE)))
    out.append(("synthesis_untextured", hl.SIZE,
                _synthesis_calls(dev, rc, assets, 2, "raster_cols")[0]))
    for i, args in enumerate(_synthesis_calls(dev, rc, dense, 3, "raster_cols")):
        out.append((f"synthesis_chunked_call{i}", hl.SIZE, args))
    return out


def topk_cases(dev, rc):
    """(case, size, args) of every top-k-kernel call to time."""
    from deepim_tpu_torch import headline as hl

    assets = hl.headline_assets(dev)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, hl.B)
    return [(case, size, args)
            for case, size, args, _ in chip_smoke.topk_cases(dev, assets, init, ks, cls, rc)]


CASES = {"cols": cols_cases, "sorted": sorted_cases, "topk": topk_cases}


def e2e(dev, n: int) -> dict:
    """Wall ms per call (median, quartiles over n) of refine_poses on the
    cols and the sort route, and of untextured and chunked synthesis."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data import synthetic_occlusion_batch
    from deepim_tpu_torch.raster.camera import make_intrinsics

    assets = hl.headline_assets(dev)
    sort_assets = hl.headline_assets(dev, dense_sphere=False)
    dense = chip_smoke.dense_assets(dev)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, hl.B)
    model = hl.random_model(assets.num_classes).to(dev)
    k = make_intrinsics(*hl.LINEMOD_K, device=dev)

    def synthesis(a, distractors):
        return lambda: synthetic_occlusion_batch(
            torch.Generator(device=dev).manual_seed(hl.SEED), a, hl.B, k, hl.SIZE,
            num_distractors=distractors)

    calls = {
        "refine_poses_cols_route": lambda: hl.run_headline(model, assets, obs, init, ks, cls),
        "refine_poses_sort_route": lambda: hl.run_headline(model, sort_assets, obs, init,
                                                           ks, cls),
        "synthesis_untextured": synthesis(assets, 2),
        "synthesis_chunked": synthesis(dense, 3),
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
    ap.add_argument("--kernel", choices=sorted(CASES), default="sorted",
                    help="the kernel whose cases are timed")
    ap.add_argument("--tree", type=Path, default=chip_smoke.ROOT,
                    help="checkout whose deepim_tpu_torch is timed")
    ap.add_argument("--e2e", type=int, default=0, metavar="N",
                    help="time N end-to-end calls of each main path instead")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_raster: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(opts.tree.resolve()))
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.raster import _build
    from deepim_tpu_torch.raster import raster_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(hl.card(), flush=True)
    info = _build.build()
    ptxas = chip_smoke.ptxas_summary(info.log).get(f"raster_{opts.kernel}_kernel",
                                                   "no nvcc log: an earlier run's build")
    dev = torch.device("cuda", 0)
    if opts.e2e:
        print(json.dumps({"tree": str(opts.tree), "e2e": e2e(dev, opts.e2e)}), flush=True)
        return 0
    kern = getattr(rc, f"raster_{opts.kernel}")
    for name, (h, w), args in CASES[opts.kernel](dev, rc):
        kern(*args)  # warm
        ms = chip_smoke.ms_per_call(lambda: kern(*args), REPS)
        print(json.dumps({"tree": str(opts.tree), "kernel": opts.kernel, "case": name,
                          "size": f"{h}x{w}", "batch": args[0].shape[0],
                          "faces": args[0].shape[1], "ms": ms, "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
