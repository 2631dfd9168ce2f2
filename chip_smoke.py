#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``deepim_tpu_torch``).

Run from the repository root on a machine with an NVIDIA GPU (the kernels
are built for Hopper, ``sm_90a``)::

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits nonzero):

1. Device: the card's name and its ``nvidia-smi`` name and power limit.
2. Build: the two crop-raster CUDA kernels from ``deepim_tpu_torch/raster/csrc``.
3. Kernels against their plain PyTorch versions on the binned inputs the
   main path gives them, at 480x640 and 240x320 with B=128: the cols
   kernel on the headline's 1,280 faces; the sorted kernel on the cols
   path's fallback binning and on the sort route of sub-1,024-face assets
   (spans (8, 3), whose global list must be nonempty at 480x640); then a
   mesh that overflows the cols kernel's global list into the sorted
   fallback.  Kernel and plain version must agree bit for bit
   (max_abs_err 0); the mismatch fractions at the repo's raster tolerance
   are printed beside it, and both are timed (CUDA events, warmed, in
   turns).
4. Slice parity: ``refine_poses`` on the card (kernels) against the same
   call on the CPU (plain versions), float32, TF32 off, B=8.
5. Main path: ``refine_poses`` at the headline protocol (B=128, K=4: 2
   iterations at 240x320 then 2 at 480x640, four procedural classes,
   back-face culling on, bf16 network, random weights from a seed; see
   ``deepim_tpu_torch/headline.py``), then the same protocol on
   sub-1,024-face meshes (the sorted kernel's crop route).  Launches are
   counted from zero for each of the two runs; then poses/s of the
   headline pipelined over 8 batches and the serial median of 5.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
next to it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PARITY_B = 8
PARITY_ATOL = 1e-3  # the CPU trajectory test's tolerance
RGB_ATOL, DEPTH_ATOL = 2e-2, 1e-3  # the repo's raster tolerance, printed beside


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def mismatch(a, b):
    """Fractions of rgb and depth elements outside the raster tolerance, and
    the largest absolute difference."""
    (rgb_a, d_a), (rgb_b, d_b) = a, b
    rgb = (~torch.isclose(rgb_a, rgb_b, atol=RGB_ATOL)).float().mean().item()
    dep = (~torch.isclose(d_a, d_b, atol=DEPTH_ATOL)).float().mean().item()
    err = max((rgb_a - rgb_b).abs().max().item(), (d_a - d_b).abs().max().item())
    return rgb, dep, err


def time_in_turns(kernel, plain, reps_kernel=20, reps_plain=3):
    """ms per call of each, timed with CUDA events in the order plain,
    kernel, kernel, plain after one warm call each."""
    def run(fn, reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kernel(), plain()
    p1 = run(plain, reps_plain)
    k1 = run(kernel, reps_kernel)
    k2 = run(kernel, reps_kernel)
    p2 = run(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def compare(name, kern, plain, args, **fields):
    """Kernel against its plain version on the same inputs, timed.  The two
    evaluate every plane with the same rounded operations, so they must
    agree bit for bit (max_abs_err 0)."""
    out_k = kern(*args)
    torch.cuda.synchronize()
    out_p = plain(*args)
    frac_rgb, frac_d, err = mismatch(out_k, out_p)
    ms, plain_ms = time_in_turns(lambda: kern(*args), lambda: plain(*args))
    covered = (out_p[1] > 0).float().mean().item()
    log("kernels", kernel=name, **fields, batch=args[0].shape[0], faces=args[0].shape[1],
        rgb_mismatch=frac_rgb, depth_mismatch=frac_d, max_abs_err=err,
        covered=covered, ms=ms, plain_ms=plain_ms)
    if err != 0.0 or covered < 0.05:
        raise AssertionError(f"{name} {fields} disagrees with its plain version")
    return {**fields, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(dev, assets, sort_assets, init, ks, cls, rc):
    """Each kernel against its plain version on the inputs the main path
    gives it: the headline's cols route, the cols path's fallback binning,
    and the sort route of sub-1,024-face assets; then a mesh that
    overflows the cols kernel's global list."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.ops.zoom import compute_zoom_box, zoom_intrinsics
    from deepim_tpu_torch.refine import gather_class

    record = {"raster_cols": [], "raster_sorted": []}
    for size in (hl.SIZE, hl.COARSE):
        h, w = size
        tag = f"{h}x{w}"
        for a in (assets, sort_assets):
            ab = gather_class(a, cls)
            kz = zoom_intrinsics(ks, compute_zoom_box(init, ks, ab.corners, size))
            params, bbox, ok = rc.pack_tri_params(ab.tri_pos, ab.tri_col, ab.tri_nrm,
                                                  init, kz, rc.FLAT_LIGHTING, 0.01,
                                                  ab.cull_dir)
            if a is sort_assets:
                # render_crops' sort route: spans (8, 3), faces taller than
                # 8 tiles go on the global list.
                binned = rc.bin_faces_sorted(bbox, ok, size, sy_span=8, sx_span=3)
                n_glob = int(binned[2][:, 0].max())
                record["raster_sorted"].append(compare(
                    "raster_sorted", rc.raster_sorted, rc.raster_sorted_ref,
                    (params, *binned, h, w), case="sort_route", size=tag,
                    global_faces_max=n_glob))
                if size == hl.SIZE and n_glob == 0:
                    raise AssertionError("the sort route's global list is empty: "
                                         "its walk went unchecked")
                continue
            record["raster_cols"].append(compare(
                "raster_cols", rc.raster_cols, rc.raster_cols_ref,
                (params, *rc.bin_faces_packed(bbox, ok, size), h, w),
                case="cols_route", size=tag))
            # The cols path's fallback binning: spans over the whole grid.
            record["raster_sorted"].append(compare(
                "raster_sorted", rc.raster_sorted, rc.raster_sorted_ref,
                (params, *rc.bin_faces_sorted(bbox, ok, size, sy_span=-(-h // 32),
                                              sx_span=-(-w // 256)), h, w),
                case="fallback_binning", size=tag))

    # A mesh with more big faces than the cols global cap: the cols route
    # must fall back to the sorted kernel and agree with the plain path.
    from deepim_tpu_torch.geometry.rotations import euler2mat
    from deepim_tpu_torch.geometry.se3 import se3_from_rt
    from deepim_tpu_torch.raster.mesh import cylinder_mesh

    m = cylinder_mesh(radius=0.05, height=0.3, segments=512, rows=1)
    tri = [torch.from_numpy(a[m.faces].reshape(-1, 9).T.copy())[None].expand(2, 9, -1)
           for a in (m.vertices, m.colors, m.normals)]
    poses = torch.stack([
        se3_from_rt(euler2mat(*map(torch.tensor, (math.pi / 2, 0.0, 0.0))),
                    torch.tensor([0.0, 0.0, 0.4])),
        se3_from_rt(euler2mat(*map(torch.tensor, (math.pi / 2, 0.15, 0.1))),
                    torch.tensor([0.01, 0.0, 0.45])),
    ])
    h, w = hl.SIZE
    f = 180.0 * h / 64  # tests/test_raster_pallas.py's zoom, scaled to the crop
    k = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]).expand(2, 3, 3)
    rc.reset_launches()
    out_k = rc.render_batch_tri(*(t.to(dev) for t in (*tri, poses, k)), hl.SIZE,
                                binning="cols")
    torch.cuda.synchronize()
    counts = dict(rc.LAUNCHES)
    out_p = rc.render_batch_tri(*tri, poses, k, hl.SIZE, binning="cols")
    frac_rgb, frac_d, err = mismatch([t.cpu() for t in out_k], out_p)
    log("kernels", case="cols_overflow_fallback", size=f"{h}x{w}", launches=counts,
        rgb_mismatch=frac_rgb, depth_mismatch=frac_d, max_abs_err=err)
    if counts != {"raster_cols": 0, "raster_sorted": 1, "cols_fallback": 1}:
        raise AssertionError(f"overflow mesh did not take the sorted fallback: {counts}")
    if err != 0.0:
        raise AssertionError("sorted fallback disagrees with its plain version")
    record["raster_sorted"].append(
        {"case": "cols_overflow_fallback", "size": f"{h}x{w}", "max_abs_err": err})
    return record


def phase_parity(model_f32, assets, obs, init, ks, cls):
    """refine_poses with the kernels (card) against the plain versions (CPU)."""
    from deepim_tpu_torch import headline as hl

    sl = slice(0, PARITY_B)
    args = (obs[sl], init[sl], ks[sl], cls[sl])
    t0 = time.perf_counter()
    traj_k = hl.run_headline(model_f32, assets, *args, return_all=True).cpu()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    traj_p = hl.run_headline(copy.deepcopy(model_f32).cpu(), assets.to("cpu"),
                             *(a.cpu() for a in args), return_all=True)
    t_cpu = time.perf_counter() - t0
    diff = (traj_k - traj_p).abs().max().item()
    moved = (traj_k[-1] - traj_k[0]).abs().max().item()
    log("parity", batch=PARITY_B, max_pose_diff=diff, atol=PARITY_ATOL,
        moved=moved, card_s=t_card, cpu_s=t_cpu)
    if not diff <= PARITY_ATOL or not moved > 1e-3:
        raise AssertionError("refine_poses on the card disagrees with the CPU path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "deepim_tpu_torch" / "raster" / "csrc").is_dir():
        print(f"chip_smoke: deepim_tpu_torch not found next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.raster import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = hl.card()
    print(card, flush=True)
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    log("build", seconds=time.perf_counter() - t0, nvcc_seconds=info.seconds,
        library=info.path.name)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)

    kernels = run_phases(dev, card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def run_phases(dev, card: str) -> list[dict]:
    """Phases 3-5 on ``dev``; returns the kernels' JSON record."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.raster import raster_cuda as rc

    assets = hl.headline_assets(dev)
    sort_assets = hl.headline_assets(dev, dense_sphere=False)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, hl.B)
    log("setup", faces=assets.tri_pos.shape[2], sort_route_faces=sort_assets.tri_pos.shape[2],
        lod=assets.lod is not None, classes=assets.num_classes, batch=hl.B)
    record = phase_kernels(dev, assets, sort_assets, init, ks, cls, rc)

    model_f32 = hl.random_model(assets.num_classes, dtype=torch.float32).to(dev)
    phase_parity(model_f32, assets, obs, init, ks, cls)

    model = copy.deepcopy(model_f32)
    model.dtype = torch.bfloat16

    def run(a=assets):
        return hl.run_headline(model, a, obs, init, ks, cls)

    run(), run(sort_assets)  # warm (cuDNN algorithm choice, caching allocator)
    torch.cuda.synchronize()
    # The main path: refine_poses on the headline assets (the cols route),
    # then on the sub-1,024-face assets (the sort route); each run's
    # launches are counted from zero.
    counts, outs = {}, {}
    for run_name, a in (("headline", assets), ("sort_route", sort_assets)):
        rc.reset_launches()
        outs[run_name] = run(a)
        torch.cuda.synchronize()
        counts[run_name] = dict(rc.LAUNCHES)
        log("main_path", run=run_name, faces=a.tri_pos.shape[2], renders=hl.K_ITERS,
            cols_launches=counts[run_name]["raster_cols"],
            sorted_launches=counts[run_name]["raster_sorted"],
            fallback_renders=counts[run_name]["cols_fallback"])
    for o in outs.values():
        if o.shape != (hl.B, 3, 4) or not torch.isfinite(o).all():
            raise AssertionError("refined poses are not finite (B, 3, 4)")
        if not (o - init).abs().max().item() > 1e-3:
            raise AssertionError("the poses did not move")
    if counts["headline"]["raster_cols"] != hl.K_ITERS:
        raise AssertionError(f"a headline render missed the cols kernel: {counts['headline']}")
    if counts["sort_route"]["raster_sorted"] != hl.K_ITERS or counts["sort_route"]["raster_cols"]:
        raise AssertionError(f"sort-route renders missed the sorted kernel: {counts['sort_route']}")

    pipe_reps = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = [run() for _ in range(pipe_reps)]
    torch.cuda.synchronize()
    pipelined = hl.B * pipe_reps / (time.perf_counter() - t0)
    del pending
    serial = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        serial.append(time.perf_counter() - t0)
    log("headline", poses_per_s_pipelined=pipelined,
        poses_per_s_serial_median5=hl.B / statistics.median(serial),
        serial_ms=[s * 1e3 for s in serial], batch=hl.B, iters=hl.K_ITERS,
        coarse_iters=hl.COARSE_ITERS, dtype="bf16", card=repr(card))

    kernels = []
    for kname, src, line, headline_case in (
            ("raster_cols", "raster_cols.cu", 418, "cols_route"),
            ("raster_sorted", "raster_sorted.cu", 758, "sort_route")):
        main = next(r for r in record[kname]
                    if r["case"] == headline_case and r["size"] == "480x640")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"deepim_tpu_torch/raster/csrc/{src}",
            "replaces": f"deepim_tpu/raster/raster_pallas.py:{line}",
            "launches": counts["headline"][kname] + counts["sort_route"][kname],
            "launches_headline": counts["headline"][kname],
            "launches_sort_route": counts["sort_route"][kname],
            "max_abs_err": max(r["max_abs_err"] for r in record[kname]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "timed_case": f"{headline_case} 480x640",
        })
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
