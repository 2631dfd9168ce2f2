#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``deepim_tpu_torch``).

Run from the repository root on a machine with an NVIDIA GPU (the kernels
are built for Hopper, ``sm_90a``)::

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits nonzero):

1. Device: the card's name and its ``nvidia-smi`` name and power limit.
2. Build: the three raster CUDA kernels from ``deepim_tpu_torch/raster/csrc``
   (one ``nvcc`` per source, all started together).
3. Kernels against their plain PyTorch versions on the binned inputs the
   main path gives them, at 480x640 and 240x320 with B=128: the cols
   kernel on the headline's 1,280 faces (and on 204x296 crops of them,
   whose last 128-px column is 40 pixels wide and whose last row of
   sub-tiles 4 pixels high: the clipped warp rectangles); the sorted
   kernel on the cols path's fallback binning and on the sort route of sub-1,024-face assets
   (spans (8, 3), whose global list must be nonempty at 480x640), and at
   240x320 on the decimated level (``lod_faces=1024``) of classes padded
   to 4,096 faces (the coarse iterations of real-size assets); then a mesh that overflows the
   cols kernel's global list into the sorted fallback.  Kernel and plain
   version must agree bit for bit (max_abs_err 0); the mismatch fractions
   at the repo's raster tolerance are printed beside it, and both are
   timed (CUDA events, warmed, in turns).  Each line carries the call's
   bound: the bytes it must move (the id entries it walks, 48 B of
   coverage and depth planes for each listed face and 36 B of colour
   planes for each face that wins a pixel, read once; 16 B a pixel
   written once) at 3.35 TB/s against its plane work (16 fp32 operations
   per pixel centre inside a listed face's bbox) at 67 TFLOP/s, the
   larger of the two, and its share of the measured time, and the
   kernel's ptxas registers and spills.
4. Slice parity: ``refine_poses`` on the card (kernels) against the same
   call on the CPU (plain versions), float32, TF32 off, B=4.
5. Main path: ``refine_poses`` at the headline protocol (B=128, K=4: 2
   iterations at 240x320 then 2 at 480x640, four procedural classes,
   back-face culling on, bf16 network, random weights from a seed; see
   ``deepim_tpu_torch/headline.py``), then the same protocol on
   sub-1,024-face meshes (the sorted kernel's crop route).  Launches are
   counted from zero for each of the two runs; then poses/s of the
   headline pipelined over 8 batches and the serial median of 5.
6. The top-k kernel against its plain version at B=128, 480x640 and
   240x320: on the headline crops binned at 512 faces per tile, and on a
   full-frame shared-mesh ``render_batch`` pack (whose tiles overflow the
   cap); bit for bit, timed, with the number of tiles at the cap.
7. Scene synthesis, this slice's main path: ``synthetic_occlusion_batch``
   at B=128, 480x640, LINEMOD K, three runs with launches counted from
   zero for each: untextured headline classes with 2 distractors (3,840
   scene faces: the sorted kernel; the target-only depth: the cols
   kernel), the textured headline classes (the deferred pass; its peak
   memory), and classes padded to 4,096 faces with 3 distractors (16,384
   faces: two cols chunks z-merged).  Samples/s of each.  Then every
   kernel call of each run against its plain version on the packed and
   binned inputs the run gave it (the 3,840-face scene, both chunks, the
   target-only depth), bit for bit.
8. The top-k route through ``render_batch``, ``render_batch_tri`` and
   ``render_batch_textured`` (``binning="topk"``, B=128, 480x640): each
   launches the top-k kernel and warns as the reference does.
9. Card against CPU, float32: ``render_scene`` at B=2 with each synthesis
   run's assets and slot count, the chunked one z-merging two cols chunks
   (raster tolerance), ``refine_poses`` on the textured headline assets at
   B=4 (atol 1e-3).
10. Serving: ``PoseRefinerService`` at the flagship config
   (``synthetic_all_c2f``: four classes of at most 576 faces, the sorted
   kernel's route; 480x640, K=4 of which 2 coarse, bf16) with a device
   batch of 128, loaded from a port checkpoint of random weights.  8
   clients send one 32-pose request each while 4 send eight 1-pose
   requests each; every result against a direct ``refine_poses`` on the
   same rows (atol 1e-3), 1-pose latency p50/p99, 4 sorted launches per
   device batch.  Then 4 clients x 4 requests of 128 poses: the service's
   poses/s against the direct call's, and the worker's host time per
   batch (stacking 128 frames, copying them to the card) against its
   refine time.  Last, the service's model and flagship assets card
   against CPU at float32 (the sorted kernel, atol 1e-3, B=4).
11. Selection and tracking on the headline assets (the cols kernel):
   ``refine_multi_hypothesis`` at B=32 x 4 hypotheses (K + 1 cols
   launches; ``select_margin=inf`` returns hypothesis 0 bit for bit);
   ``refine_video`` over 8 shared frames of a 32-object scene, plain and
   with recovery armed (half the tracks start 8 cm off; the frames that
   re-acquire and the armed run's peak memory); then card against CPU at
   float32: ``score_poses`` (atol 1e-4, with and without observed depth),
   ``select_hypotheses`` on given hypotheses at margin 0 (the same
   winners, at least one not hypothesis 0) and plain ``refine_video``
   (atol 1e-3).
12. Training at the flagship config (``headline.TRAIN_CONFIG``,
   synthetic_all: B=32, 480x640, ``train_iter`` 2, flow + mask heads, bf16,
   Adam; four classes of at most 576 faces, the sorted kernel's route):
   the fused synthesize-and-train step over 20 steps at 480x640 and at the
   coarse size 240x320, with steps/s, samples/s, peak MiB, its sorted and
   cols launches per step (1 + ``train_iter`` sorted, 0 cols), model FLOPs
   counted from the layer shapes and their share of the bf16 dense peak
   (``mfu``); the ms of its parts (synthesis, network inputs, flow GT,
   losses forward + backward, optimizer), each timed alone.  Then the
   micro-overfit of ``tests/test_train.py`` (80 steps on a fixed batch);
   150 fresh-batch steps of ``synthetic_small.yaml`` through
   ``cli.train.main`` (mean loss of the first and last 50 steps, which
   must fall) and ``--resume`` to 200; last, one train step card against
   CPU at B=2, 480x640 (float32 at train_iter 2: losses and monitors rtol
   1e-4; the card's float32 gradient within 1e-1 of each leaf's max of
   its float64 one; float64 at train_iter 1: also the gradient norm, and
   each gradient within 1e-3 of its leaf's max; float64 at train_iter 2,
   each iteration's inputs card against CPU printed: each gradient within
   5e-2 of its leaf's max, and within 1e-3 where the card takes the CPU's
   zoom box, k_zoom and updated pose; Adam on shared gradients: params
   within 1e-6).  Before synthetic_small's directory goes, ``cli.test``
   scores its 200-step checkpoint on 512 samples: INIT against iteration
   4, each with its 95 % interval (printed, not gated).
13. Evaluation at the flagship config (``synthetic_all_c2f.yaml``: 480x640,
   test B=32, K=4 of which 2 coarse, bf16, four classes of at most 576
   faces) through ``cli.test.main`` from a port checkpoint of the seed-7
   random model: 2,048 samples with --save-poses (refine poses/s, seconds,
   the evaluator's seconds, peak MiB, 5 sorted and 0 cols launches a
   batch, the BOP CSV against the last iterate within 1e-6); a warm
   batch's synthesis and refinement ms each alone; the evaluator alone on
   its 5 x 2,048 rows at 3,000 points (ms, peak MiB) and the ADD-S cross
   term's peak on one chunk of 256 rows as three products and as the
   broadcast product it replaced; --no-refine --vis 2 (the same INIT
   row, two montages); --hypotheses 4 at 45°/6 cm inits on 256 samples (6
   sorted launches a batch); occlusion_small.yaml on 256 samples (6
   sorted, 0 cols a batch at 576 faces) and on synthetic_dense's classes
   (20,480 faces: cols every batch); then card against CPU: each
   per-sample error of the first 256 rows within rtol 1e-5 (atol 1e-7 m,
   1e-5°, 1e-4 px), the tables equal but for samples at a threshold
   (counted), and one eval batch (B=4, float32) through the eval loop
   (trajectories within 1e-5).
14. The video toolkit and tracking at the flagship dataset through
   ``cli.track.main``: 4 single-object sequences of 8 frames in windows
   of 4 (gen_video's render and PNG-write ms a frame, 2 sorted launches a
   generated frame, frames/s, 18 sorted launches a sequence); the same
   call again reuses the data (no "generating" line), --num-frames 6 does
   not; recovery armed over 2 occluders; ``_render_frame`` of a 2-object
   frame card against CPU (raster tolerance; labels equal off depth ties
   within 1e-5 m).
15. The on-disk datasets at ``lm6d_all.yaml`` (480x640 frames and network,
   test B=16, K=4, bf16, ``test.init: posecnn``, four classes of at most
   576 faces): ``gen_procedural_dataset`` on the card (64 frames an object:
   frames/s, render and PNG-write ms a frame, 1 sorted launch an object)
   and ``gen_rendered`` on its train split; the PNG decoder, plain Python
   rows against the C++ unfilter, on a 480x640 RGB frame and its 16-bit
   depth written with filter 0, Sub/Up and Paeth rows (ms, arrays equal);
   ``cli.test.main`` on the root and on a copy whose test PNGs are all
   Paeth rows (poses/s, 4 sorted and 0 cols launches a batch, the two
   tables equal, the BOP CSV's real ids); ``--init-poses`` from a BOP CSV
   (every record matched, the same INIT row); the loader alone, the
   refinement alone and the streamed loop over 4 passes of the test split,
   each frame PNG decoded by one ``native.decode_png`` call (ms a batch,
   the device's idle share from torch.profiler, the host's
   float32 conversion against the card's copy and conversion); the card's
   uint8/uint16 conversion bit for bit the host's over every value; one
   on-disk batch card against CPU (float32, within 1e-5); a root of
   20,480-face textured OBJ models decimated to 4,096 on load (cols
   launches a batch); 20 steps of ``cli.train.main`` on disk at
   ``syn_fraction`` 0.5 (ms a disk and a synthetic step, the loader's wait,
   finite losses, the last 5 below the first 5); the YCB-Video keyframe
   protocol with ``--posecnn-mat`` on ``gen_video``'s data (every record
   matched, one decode a keyframe a batch).
16. Public releases at ``lm6d_all.yaml`` (480x640, test B=16, K=4, bf16): a
   root generated on the card (8 frames an object) re-laid out by
   ``tests/test_torch_release_fixtures.py`` as a BOP JSON release (mm,
   ``depth_scale`` 0.1, ``mask_visib``), a SIXD YAML one, an original
   LINEMOD one (baseline JPEG frames, ``.dpt`` in mm, ``.tra`` in cm, mm
   mesh) and an original YCB-Video one (``-meta.mat``, 1-based global ids,
   ``factor_depth`` 10000, ``keyframe.txt``); the JPEG decoder, C++ against
   plain, on a 480x640 frame at 4:2:0 and at 4:4:4 with restart markers
   (ms, arrays equal); each release through ``cli.runbook`` on the card
   (detect, convert, validate, ``cli.test``: conversion frames/s,
   validation seconds, no ERROR, poses/s, 4 sorted and 0 cols launches a
   batch, peak MiB) and its converted root against the generated one
   (poses within 1e-6 m, labels and RGB equal, depth within 1 mm); a copy
   of the BOP release in metres stops with exit code 2 naming
   ``bop-t-meters``; a BOP release of 20,480-face meshes (cols launches);
   the seed-7 model exported with ``export_mxnet_npz`` through
   ``--weights``: its table and trajectories equal to the same model
   loaded directly, and one converted-root batch card against CPU
   (float32, ``mxnet_pad``, within 1e-5).
17. int8 inference (``network.quant``): the headline (B=128, K=4 of which
   2 coarse, the 1,280-face classes, seed-7 weights) at quant none, int8
   and int8_static (scales calibrated on the headline batch, estimator
   max), timed in turns in one process: poses/s, the raster launches and
   ``_int_mm`` calls of one call, peak MiB, the calibration's seconds;
   each encoder conv and fc1/fc2 at 480x640: the ms of the quantize, the
   patch matrix, the ``_int_mm`` calls and the dequantize, the whole int8
   layer, and the bf16 cuDNN conv / linear on the same input, beside the
   ``_int_mm`` bound (bytes at 3.35 TB/s or int8 operations at 1,979
   TOP/s); the int8 network card against CPU on identical inputs at B=2
   (float32: within 1e-5 of the outputs' scale, the encoder printed;
   bf16 printed), dynamic and static; ``refine_poses`` int8 card against
   CPU at B=4 (atol 1e-2: an ulp of the zoom moves an int8 value a step);
   ``PoseRefinerService`` at the flagship config with quant int8_static
   (calibrated at construction; 4 clients of 16 poses, each result
   against a direct ``refine_poses`` within 1e-3); ``cli.test --quant
   int8_static`` on ``synthetic_small.yaml`` (exit 0, the calibration
   line, the table); a progressive JPEG and an Adam7-interlaced PNG of a
   480x640 frame rendered on the card, C++ against plain (arrays equal,
   ms a frame).
18. The C++ host runtime (``deepim_tpu_torch/native.py`` over
   ``csrc/deepim_native.cpp``) and the protocol tools: the library built
   afresh (``g++ --version``, whether ``zlib.h`` is found); icospheres of
   81,920 and 327,680 faces as ASCII PLY and OBJ through load, vertex
   normals and decimation to 4,096, C++ against plain (geometry equal,
   normals within 4 float32 ulps; ms of each); ``decode_png`` C++ against
   plain on phase 15's frame at filter 0 and Paeth, RGB and 16-bit depth
   (ms, arrays equal); ``PrefetchReader`` over phase 15's test split
   against ``open().read()``; phase 15's streamed idle share (its frames
   decoded one C++ call a PNG) beside PR 8's 74 %; a root of untextured
   20,480-face OBJ models decimated in C++ to 3,996 faces through
   ``cli.test`` as two seeds (4 cols launches a batch, the C++ calls
   counted) and ``tools.seed_variance`` over the two; ``tools.
   robustness_curve`` (64 samples, 5° and 30°: sorted) and
   ``tools.decimation_ab`` (budgets 1,024, 4,096 and 0 on 64 samples:
   cols, two face chunks at 20,480) on the seed-7 flagship checkpoint,
   with their launches; ``tools.supervise_train`` on ``synthetic_small``
   with its trainer killed (SIGKILL) after the first checkpoint: it
   relaunches with ``--resume``, reaches the done line and exits 0.
19. Ranks (``deepim_tpu_torch/parallel``, one process each, spawned;
   rank r on cuda:(r % cards), NCCL when each rank has a card of its own,
   gloo when ranks share one): at the flagship training config
   (``headline.TRAIN_CONFIG``), a one-rank NCCL group takes NCCL_STEPS
   fused steps through the ``mesh=`` path (the first step's loss and
   gradient norm within rtol 1e-4 of the same step without a mesh, all
   losses finite), while ``dryrun_multichip 2 --device cuda`` (three OK
   lines, backend gloo) and the last four tools run beside it:
   ``demo_render``'s images, ``plot_train`` on phase 12's
   ``train_log.jsonl``, ``gen_lm6d_cfgs`` equal to
   ``experiments/cfgs/lm6d/``, ``scale_eval_demo --frames 1024`` and its
   peak RSS.  Then four gloo ranks on this card (one spawn): two of them
   take DP_STEPS fused steps of 16 samples a rank (samples/s of two
   processes time-slicing one card, the all-reduce's ms a step, peak MiB
   and sorted launches a rank, 3 a step; the ranks' parameters bit for
   bit equal after); then one float32 step at 480x640 and a global batch
   of 8 (TF32 off) on a (2, 1) and a (1, 2) mesh of two ranks and a
   (2, 2) mesh of all four, each against one process's step on the whole
   batch (gradients within 1e-3 of each leaf's max abs, loss rtol 1e-5;
   fc1's shard half the weight).  Last, ``cli.test`` at synthetic_all_c2f
   (256 samples, --save-poses) under ``torch.distributed.run`` on two
   ranks against one process (poses within 1e-3, 5 sorted launches a
   batch a rank, both tables).

The line before the last is the kernels' JSON record (each kernel's
launches on the main paths, its time, plain time and bound at 480x640,
``library_ms`` null: no single PyTorch call rasterizes); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
next to it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PARITY_B = 4  # card-against-CPU refinement rows (8 until the script passed ~1,000 s)
SCENE_PARITY_B = 2  # render_scene card against CPU (8 until the on-disk phase, 4 until phase 19)
FLAGSHIP_PARITY_B = 4  # the service's flagship parity (8 until the training phase came)
PARITY_ATOL = 1e-3  # the CPU trajectory test's tolerance
RGB_ATOL, DEPTH_ATOL = 2e-2, 1e-3  # the repo's raster tolerance, printed beside
RASTER_FRAC = 0.002  # card-vs-CPU renders: at most this share of elements off
TOPK_CAP = 512  # the reference's default max_faces_per_tile
# Peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM bytes/s and
# fp32 operations/s outside the tensor cores.  A face's plane work at one
# pixel is 4 planes x (2 mul + 2 add).
HBM_BYTES_PER_S, FP32_OPS_PER_S, OPS_PER_PAIR = 3.35e12, 67e12, 16
# Bytes of a face's planes (raster_cuda.py §_plane_pack): three
# barycentrics and the inverse depth, to test it at a pixel; three colour
# numerators, read only where it wins.
TEST_BYTES, COLOUR_BYTES = 48, 36


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


def ms_per_call(fn, reps):
    """Mean ms of ``reps`` back-to-back calls of ``fn``, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(kernel, plain, reps_kernel=20, reps_plain=3):
    """ms per call of each, timed with CUDA events in the order plain,
    kernel, kernel, plain after one warm call each."""
    kernel(), plain()
    p1 = ms_per_call(plain, reps_plain)
    k1 = ms_per_call(kernel, reps_kernel)
    k2 = ms_per_call(kernel, reps_kernel)
    p2 = ms_per_call(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def peak_memory(fn):
    """``fn()`` and the device memory it held at its peak above what was
    allocated before it, in MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


KERNEL_NAMES = ("raster_cols_kernel", "raster_sorted_kernel", "raster_topk_kernel")
PTXAS: dict[str, str] = {}  # filled from the build's log by main()


def ptxas_summary(log_text: str) -> dict[str, str]:
    """Registers and spills of each kernel in ``nvcc -Xptxas -v`` output,
    keyed by the kernel's (unmangled) name."""
    out, current = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            current = next((k for k in KERNEL_NAMES if k in line), None)
        elif current and ("spill stores" in line or "registers" in line):
            part = line.split(":", 1)[-1].strip()
            out[current] = f"{out[current]}; {part}" if current in out else part
    return out


def _centres(lo, hi, a, b):
    """How many pixel centres c + 0.5, for integer c in [a, b), lie in
    [lo, hi] (elementwise, float64)."""
    first = torch.maximum(torch.ceil(lo - 0.5), a)
    last = torch.minimum(torch.floor(hi - 0.5), b - 1)
    return (last - first + 1).clamp_min(0)


def _pairs(bbox, ids, valid, ox, oy, rw, rh, h, w):
    """Pixel centres inside each listed face's bbox and its region
    [ox, ox+rw) x [oy, oy+rh) clipped to the image, summed.  ``ids``,
    ``valid``, ``ox``, ``oy`` are (B, N)."""
    bb = torch.gather(bbox.double(), 1, ids.long().clamp_min(0)[..., None].expand(-1, -1, 4))
    ox, oy = ox.double(), oy.double()
    nx = _centres(bb[..., 0], bb[..., 1], ox, torch.clamp(ox + rw, max=w))
    ny = _centres(bb[..., 2], bb[..., 3], oy, torch.clamp(oy + rh, max=h))
    return float((nx * ny * valid).sum())


def _range_entries(starts, n):
    """Region index of each of n entries of a sorted id array whose regions
    start at ``starts`` (B, R+1), and whether the entry lies in a region."""
    idx = torch.arange(n, device=starts.device).expand(starts.shape[0], n).contiguous()
    region = torch.searchsorted(starts.long().contiguous(), idx, right=True) - 1
    return region.clamp(0, starts.shape[1] - 2), idx < starts[:, -1:]


def _mark(listed, ids, ok):
    """Mark in ``listed`` (B, F) the faces of the walked entries ``ids[ok]``
    (both (B, N)); returns how many entries are walked."""
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    listed[rows[ok], ids[ok].long()] = True
    return int(ok.sum())


def winning_faces(kern, args):
    """How many faces win at least one pixel, summed over the batch: the
    call again with each face's colour planes (params 12-20) set to the
    constant id + 1, read back as rgb / depth (exact: both carry the
    pixel's same 1 / z)."""
    params, *rest = args
    b, f = params.shape[:2]
    coded = params.clone()
    coded[..., 12:21] = 0.0
    coded[..., 14] = torch.arange(1, f + 1, dtype=params.dtype, device=params.device)
    rgb, depth = kern(coded, *rest)
    ids = torch.where(depth > 0, torch.round(rgb[:, 0] / depth.clamp_min(1e-30)), 0.0)
    seen = torch.zeros((b, f + 1), dtype=torch.bool, device=params.device)
    seen.scatter_(1, ids.long().reshape(b, -1), True)
    return int(seen[:, 1:].sum())


def work(name, args, bbox, n_winners):
    """What one kernel call must do.  ``bytes``: the id entries it walks
    and the range arrays that delimit them, the coverage and depth planes
    of each face listed somewhere, the colour planes of the ``n_winners``
    faces that win a pixel, each read once, and the outputs (16 B a pixel)
    written once.  ``pairs``: (pixel centre, listed face) with the centre
    inside the face's bbox, the region the face is listed for (tile,
    sub-tile, column or the whole image) and the image."""
    params, *ints, h, w = args
    b = params.shape[0]
    listed = torch.zeros(params.shape[:2], dtype=torch.bool, device=params.device)
    if name == "raster_sorted":
        vals, starts, glob = ints
        tx = -(-w // 256)
        t, ok = _range_entries(starts, vals.shape[1])
        pairs = _pairs(bbox, vals, ok, (t % tx) * 256, (t // tx) * 32, 256, 32, h, w)
        g = glob[:, 1:]
        gok = torch.arange(g.shape[1], device=g.device) < glob[:, :1]
        zero = torch.zeros_like(g)
        pairs += _pairs(bbox, g, gok, zero, zero, w, h, h, w)
        entries = _mark(listed, vals, ok) + _mark(listed, g, gok) + starts.numel() + b
    elif name == "raster_cols":
        face_ids, starts, glob_col = ints
        n_subs, n_cols = -(-h // 8), -(-w // 128)
        t, ok = _range_entries(starts, face_ids.shape[1])
        pairs = _pairs(bbox, face_ids, ok, (t // n_subs) * 128, (t % n_subs) * 8, 128, 8, h, w)
        gstarts, gids = glob_col[:, :n_cols + 1], glob_col[:, n_cols + 1:-9]
        c, gok = _range_entries(gstarts, gids.shape[1])
        pairs += _pairs(bbox, gids, gok, c * 128, torch.zeros_like(c), 128, h, h, w)
        entries = (_mark(listed, face_ids, ok) + _mark(listed, gids, gok) + starts.numel()
                   + gstarts.numel())
    else:  # raster_topk
        lists, counts = ints
        tx = -(-w // 256)
        n_t, k = lists.shape[1], lists.shape[2]
        t = torch.arange(n_t, device=lists.device).repeat_interleave(k).expand(b, -1)
        ok = (torch.arange(k, device=lists.device) < counts[..., None]).reshape(b, -1)
        pairs = _pairs(bbox, lists.reshape(b, -1), ok, (t % tx) * 256, (t // tx) * 32,
                       256, 32, h, w)
        entries = _mark(listed, lists.reshape(b, -1), ok) + counts.numel()
    n_listed = int(listed.sum())
    nbytes = (4 * entries + TEST_BYTES * n_listed + COLOUR_BYTES * n_winners
              + b * h * w * 16)
    return {"bytes": nbytes, "pairs": pairs, "listed_faces": n_listed,
            "winning_faces": n_winners}


def bound(name, args, bbox, n_winners):
    """The least time the card could take for one call: the larger of its
    bytes over the memory rate and its plane work over the fp32 rate."""
    out = work(name, args, bbox, n_winners)
    t_bytes = out["bytes"] / HBM_BYTES_PER_S
    t_ops = OPS_PER_PAIR * out["pairs"] / FP32_OPS_PER_S
    return {**out, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare(name, kern, plain, args, bbox, min_covered=0.05, reps=(20, 3), **fields):
    """Kernel against its plain version on the same inputs, timed (``reps``
    calls of each per turn), beside its bound (``bbox`` is the faces'
    screen bbox, for the plane work).  The two evaluate every plane with
    the same rounded operations, so they must agree bit for bit
    (max_abs_err 0)."""
    out_k = kern(*args)
    torch.cuda.synchronize()
    out_p = plain(*args)
    frac_rgb, frac_d, err = mismatch(out_k, out_p)
    ms, plain_ms = time_in_turns(lambda: kern(*args), lambda: plain(*args), *reps)
    covered = (out_p[1] > 0).float().mean().item()
    b = bound(name, args, bbox, winning_faces(kern, args))
    b["bound_share"] = b["bound_ms"] / ms if ms > 0 else None
    log("kernels", kernel=name, **fields, batch=args[0].shape[0], faces=args[0].shape[1],
        rgb_mismatch=frac_rgb, depth_mismatch=frac_d, max_abs_err=err,
        covered=covered, ms=ms, plain_ms=plain_ms, **b,
        ptxas=repr(PTXAS.get(f"{name}_kernel", "no nvcc log")))
    if err != 0.0 or covered < min_covered:
        raise AssertionError(f"{name} {fields} disagrees with its plain version")
    return {**fields, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}


# Crops of the headline classes at a width that is no multiple of 128 or of
# 32 and a height that is no multiple of 8: the cols kernel's last column
# holds 40 pixels (one warp's rectangle whole, one clipped to 8 columns, two
# outside the image), and its last row of sub-tiles 4 pixels' height.
ODD_CROP = (204, 296)


def crop_pack(rc, ab, init, ks, size):
    """(params, bbox, ok) of the gathered assets ``ab`` at poses ``init``,
    packed for crops of ``size`` as ``render_crops`` packs them."""
    from deepim_tpu_torch.ops.zoom import compute_zoom_box, zoom_intrinsics

    kz = zoom_intrinsics(ks, compute_zoom_box(init, ks, ab.corners, size))
    return rc.pack_tri_params(ab.tri_pos, ab.tri_col, ab.tri_nrm, init, kz,
                              rc.FLAT_LIGHTING, 0.01, ab.cull_dir)


def phase_kernels(dev, assets, sort_assets, init, ks, cls, rc):
    """Each kernel against its plain version on the inputs the main path
    gives it: the headline's cols route, the cols path's fallback binning,
    and the sort route of sub-1,024-face assets; then a mesh that
    overflows the cols kernel's global list."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.refine import gather_class

    record = {"raster_cols": [], "raster_sorted": []}
    for size in (hl.SIZE, hl.COARSE):
        h, w = size
        tag = f"{h}x{w}"
        for a in (assets, sort_assets):
            params, bbox, ok = crop_pack(rc, gather_class(a, cls), init, ks, size)
            if a is sort_assets:
                # render_crops' sort route: spans (8, 3), faces taller than
                # 8 tiles go on the global list.
                binned = rc.bin_faces_sorted(bbox, ok, size, sy_span=8, sx_span=3)
                n_glob = int(binned[2][:, 0].max())
                record["raster_sorted"].append(compare(
                    "raster_sorted", rc.raster_sorted, rc.raster_sorted_ref,
                    (params, *binned, h, w), bbox, case="sort_route", size=tag,
                    global_faces_max=n_glob))
                if size == hl.SIZE and n_glob == 0:
                    raise AssertionError("the sort route's global list is empty: "
                                         "its walk went unchecked")
                continue
            record["raster_cols"].append(compare(
                "raster_cols", rc.raster_cols, rc.raster_cols_ref,
                (params, *rc.bin_faces_packed(bbox, ok, size), h, w), bbox,
                case="cols_route", size=tag))
            # The cols path's fallback binning: spans over the whole grid.
            record["raster_sorted"].append(compare(
                "raster_sorted", rc.raster_sorted, rc.raster_sorted_ref,
                (params, *rc.bin_faces_sorted(bbox, ok, size, sy_span=-(-h // 32),
                                              sx_span=-(-w // 256)), h, w), bbox,
                case="fallback_binning", size=tag))
    h, w = ODD_CROP
    params, bbox, ok = crop_pack(rc, gather_class(assets, cls), init, ks, ODD_CROP)
    record["raster_cols"].append(compare(
        "raster_cols", rc.raster_cols, rc.raster_cols_ref,
        (params, *rc.bin_faces_packed(bbox, ok, ODD_CROP), h, w), bbox,
        case="cols_route_clipped", size=f"{h}x{w}"))

    # The coarse iterations of 4,096-face assets: the crop route at 240x320
    # on their decimated level (lod_faces=1024, under the cols crossover).
    lod = dense_assets(dev, lod_faces=hl.LOD_FACES).lod
    h, w = hl.COARSE
    params, bbox, ok = crop_pack(rc, gather_class(lod, cls), init, ks, hl.COARSE)
    if params.shape[1] >= rc._COLS_MIN_FACES_CROP:
        raise AssertionError(f"the LOD has {params.shape[1]} faces: not the sort route")
    binned = rc.bin_faces_sorted(bbox, ok, hl.COARSE, sy_span=8, sx_span=3)
    record["raster_sorted"].append(compare(
        "raster_sorted", rc.raster_sorted, rc.raster_sorted_ref, (params, *binned, h, w),
        bbox, case="sort_route_lod", size=f"{h}x{w}",
        global_faces_max=int(binned[2][:, 0].max())))

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
    if counts != {"raster_cols": 0, "raster_sorted": 1, "raster_topk": 0, "cols_fallback": 1}:
        raise AssertionError(f"overflow mesh did not take the sorted fallback: {counts}")
    if err != 0.0:
        raise AssertionError("sorted fallback disagrees with its plain version")
    record["raster_sorted"].append(
        {"case": "cols_overflow_fallback", "size": f"{h}x{w}", "max_abs_err": err})
    return record


def phase_parity(model_f32, assets, obs, init, ks, cls, batch=PARITY_B, atol=PARITY_ATOL,
                 **fields):
    """refine_poses with the kernels (card) against the plain versions (CPU)."""
    from deepim_tpu_torch import headline as hl

    sl = slice(0, batch)
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
    log("parity", **fields, batch=batch, max_pose_diff=diff, atol=atol,
        moved=moved, card_s=t_card, cpu_s=t_cpu)
    if not diff <= atol or not moved > 1e-3:
        raise AssertionError("refine_poses on the card disagrees with the CPU path")


def _shared_sphere(dev):
    """The headline's 1,280-face sphere as one vertex+faces mesh on ``dev``."""
    from deepim_tpu_torch import headline as hl

    m = hl.headline_meshes()[0][1]
    return [torch.from_numpy(a).to(dev) for a in (m.vertices, m.faces, m.colors, m.normals)]


def topk_cases(dev, assets, init, ks, cls, rc):
    """(case, (h, w), args, bbox) of the top-k kernel's two kinds of input
    at both sizes: the headline crops (crop intrinsics, back-face culling)
    binned at TOPK_CAP faces per tile, and one full-frame shared-mesh
    render_batch pack (no culling: the tiles around the sphere overflow
    the cap)."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.refine import gather_class

    ab = gather_class(assets, cls)
    b = init.shape[0]
    shared = [t.expand(b, *t.shape) for t in _shared_sphere(dev)]
    for size in (hl.SIZE, hl.COARSE):
        h, w = size
        k_full = ks.clone()
        k_full[:, :2] *= h / hl.SIZE[0]  # the camera at this image size
        for case, (params, bbox, ok) in (
                ("crop", crop_pack(rc, ab, init, ks, size)),
                ("full_frame_render_batch",
                 rc.pack_face_params(*shared, init, k_full, rc.FLAT_LIGHTING, 0.01))):
            lists, counts = rc.bin_faces_topk(bbox, ok, size, TOPK_CAP)
            yield case, size, (params, lists, counts, h, w), bbox


def phase_topk_kernel(dev, assets, init, ks, cls, rc):
    """The top-k kernel against its plain version on every case of
    :func:`topk_cases`."""
    records = []
    for case, (h, w), args, bbox in topk_cases(dev, assets, init, ks, cls, rc):
        lists, counts = args[1:3]
        records.append(compare(
            "raster_topk", rc.raster_topk, rc.raster_topk_ref, args, bbox,
            min_covered=0.05 if case == "crop" else 1e-3, case=case, size=f"{h}x{w}",
            tiles=counts.numel(), tiles_at_cap=int((counts == lists.shape[2]).sum()),
            max_count=int(counts.max())))
    return records


def dense_meshes():
    """The headline classes padded to 4,096 faces: the torus at 64x32
    segments (4,096 faces) and the cylinder with 4 rings (its side faces
    ~3 cm, under the cols kernel's span, so no chunk overflows into the
    sorted fallback)."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.raster.mesh import cylinder_mesh, torus_mesh

    meshes = hl.headline_meshes()[0]
    return [meshes[0], meshes[1], cylinder_mesh(rows=4), torus_mesh(n_major=64, n_minor=32)]


def dense_assets(dev, **kwargs):
    """Assets of :func:`dense_meshes` with the headline's symmetries."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.refine import build_assets

    return build_assets(dense_meshes(), sym_transforms=hl.headline_meshes()[1],
                        num_points=300, device=dev, **kwargs)


def synthesis_assets(dev, assets, tex_assets):
    """The three synthesis runs, (name, assets, distractors, expected
    launches): the headline assets, their textured variant, and classes
    padded to 4,096 faces."""
    one_each = {"raster_cols": 1, "raster_sorted": 1, "raster_topk": 0, "cols_fallback": 0}
    return [
        ("untextured", assets, 2, one_each),
        ("textured", tex_assets, 2, one_each),
        # 4 slots x 4,096 = 16,384 faces: chunks of 12,288 and 4,096, each
        # on the cols kernel, z-merged; the target-only depth: cols again.
        ("chunked", dense_assets(dev), 3,
         {"raster_cols": 3, "raster_sorted": 0, "raster_topk": 0, "cols_fallback": 0}),
    ]


@contextlib.contextmanager
def captured_inputs(rc):
    """Record the inputs of every raster_cols/raster_sorted call made inside
    the block as (name, args, bbox), ``bbox`` being the one its binning
    was given; the calls themselves run as usual."""
    calls, binned = [], [None]
    names = ("raster_cols", "raster_sorted", "bin_faces_packed", "bin_faces_sorted")
    saved = {n: getattr(rc, n) for n in names}

    def recording(name, fn):
        def wrapped(*args, **kwargs):
            if name.startswith("bin_"):
                binned[0] = args[0]
            else:
                calls.append((name, args, binned[0]))
            return fn(*args, **kwargs)
        return wrapped

    for n, fn in saved.items():
        setattr(rc, n, recording(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(rc, n, fn)


def phase_synthesis(dev, card, rc, runs, record):
    """synthetic_occlusion_batch at full width, B=128, 480x640, LINEMOD K:
    each run's launches counted from zero, then samples/s over 3 calls;
    then each kernel call of the run against its plain version on the
    packed and binned inputs the run gave it (appended to ``record``)."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data import synthetic_occlusion_batch
    from deepim_tpu_torch.raster.camera import make_intrinsics

    k = make_intrinsics(*hl.LINEMOD_K, device=dev)
    counts = {}
    for name, assets, nd, expect in runs:
        def run():
            g = torch.Generator(device=dev).manual_seed(hl.SEED)
            return synthetic_occlusion_batch(g, assets, hl.B, k, hl.SIZE, num_distractors=nd)

        with captured_inputs(rc) as calls:
            run()  # warm; the same draws as every later call
        rc.reset_launches()
        out, peak_mib = peak_memory(run)
        counts[name] = dict(rc.LAUNCHES)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        vis = out["visible_frac"]
        log("synthesis", run=name, batch=hl.B, size=f"{hl.SIZE[0]}x{hl.SIZE[1]}",
            scene_faces=(1 + nd) * assets.tri_pos.shape[2], launches=counts[name],
            visible_frac_mean=vis.mean().item(), scene_covered=(out["obs_depth"] > 0)
            .float().mean().item(), peak_mib=peak_mib,
            samples_per_s_median3=hl.B / statistics.median(times),
            call_ms=[t * 1e3 for t in times], card=repr(card))
        if counts[name] != expect:
            raise AssertionError(f"synthesis {name}: launches {counts[name]}, expected {expect}")
        for key in ("obs_rgb", "obs_depth", "pose_src", "pose_tgt", "visible_frac"):
            if not torch.isfinite(out[key].float()).all():
                raise AssertionError(f"synthesis {name}: {key} is not finite")
        if out["obs_rgb"].shape != (hl.B, *hl.SIZE, 3) or not vis.max().item() > 0:
            raise AssertionError(f"synthesis {name}: wrong shape or nothing visible")
        del out
        if len(calls) != counts[name]["raster_cols"] + counts[name]["raster_sorted"]:
            raise AssertionError(f"synthesis {name}: {len(calls)} kernel calls recorded")
        # The scene's sorted call or cols chunks in order, then the target's
        # depth; timed with fewer calls, the plain versions take seconds.
        for i, (kname, args, bbox) in enumerate(calls):
            plain = rc.raster_cols_ref if kname == "raster_cols" else rc.raster_sorted_ref
            record[kname].append(compare(
                kname, getattr(rc, kname), plain, args, bbox, min_covered=1e-3, reps=(5, 1),
                case=f"synthesis_{name}", call=i, size=f"{hl.SIZE[0]}x{hl.SIZE[1]}"))
        del calls
    return counts


def phase_topk_route(dev, rc, assets, tex_assets, init, ks, cls):
    """binning="topk" through the three entry points at B=128, 480x640
    (full frame, LINEMOD K): each must launch the top-k kernel and warn;
    then the deferred texture pass's peak memory, chunked and not."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.raster.textured import render_batch_textured
    from deepim_tpu_torch.refine import gather_class

    ab, abt = gather_class(assets, cls), gather_class(tex_assets, cls)
    sphere = _shared_sphere(dev)

    def textured(binning, chunk=16):
        return render_batch_textured(abt.tri_pos, abt.tri_uv, abt.tri_nrm, init, ks, hl.SIZE,
                                     abt.textures, tex_idx=abt.tex_idx, binning=binning,
                                     cull_dir=abt.cull_dir, deferred_chunk=chunk)

    calls = {
        "render_batch": lambda: rc.render_batch(*sphere, init, ks, hl.SIZE, binning="topk"),
        "render_batch_tri": lambda: rc.render_batch_tri(
            ab.tri_pos, ab.tri_col, ab.tri_nrm, init, ks, hl.SIZE, binning="topk",
            cull_dir=ab.cull_dir),
        "render_batch_textured": lambda: textured("topk"),
    }
    counts = {}
    for entry, fn in calls.items():
        torch.cuda.synchronize()
        rc.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rgb, depth = fn()
        torch.cuda.synchronize()
        counts[f"topk_{entry}"] = dict(rc.LAUNCHES)
        warned = any(issubclass(w.category, RuntimeWarning) and "DROPS" in str(w.message)
                     for w in caught)
        covered = (depth > 0).float().mean().item()
        finite = bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all())
        log("topk_route", entry=entry, launches=counts[f"topk_{entry}"], warned=warned,
            covered=covered, finite=finite)
        if rc.LAUNCHES["raster_topk"] < 1 or not warned or not finite or covered <= 0:
            raise AssertionError(f"{entry}(binning='topk') missed the top-k kernel or its warning")
    peaks = {}
    for name, fn in (("raster_only", lambda: rc.render_batch_tri(
            abt.tri_pos, abt.tri_col, abt.tri_nrm, init, ks, hl.SIZE, cull_dir=abt.cull_dir)),
            ("textured_chunk16", lambda: textured("auto")),
            ("textured_unchunked", lambda: textured("auto", 0))):
        peaks[name] = peak_memory(fn)[1]
    log("deferred_pass", batch=hl.B, size=f"{hl.SIZE[0]}x{hl.SIZE[1]}", peak_mib=peaks)
    return counts


def phase_scene_parity(dev, rc, model_f32, runs, obs, init, ks, cls):
    """render_scene on the card against the same call on the CPU, B=4,
    float32, for each synthesis run's assets and slot count (the chunked
    run: two cols chunks z-merged on each side); then textured
    refine_poses."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data.synthetic import _draw_scene
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.raster.raster_ref import Lighting
    from deepim_tpu_torch.refine import render_scene

    k = make_intrinsics(*hl.LINEMOD_K, device=dev)
    tex_assets = None
    for name, a, nd, _ in runs:
        tex_assets = a if a.textured else tex_assets
        s = _draw_scene(torch.Generator(device=dev).manual_seed(hl.SEED + 1), a.num_classes,
                        SCENE_PARITY_B, k, hl.SIZE, num_distractors=nd)
        args = (s["scene_cls"], s["scene_poses"],
                torch.ones((SCENE_PARITY_B, 1 + nd), dtype=torch.bool, device=dev),
                k.expand(SCENE_PARITY_B, 3, 3).contiguous())
        rc.reset_launches()
        out_k = render_scene(a, *args, hl.SIZE, lighting=s["lighting"])
        torch.cuda.synchronize()
        launches = dict(rc.LAUNCHES)
        t0 = time.perf_counter()
        out_p = render_scene(a.to("cpu"), *(t.cpu() for t in args), hl.SIZE,
                             lighting=Lighting(*(x.cpu() for x in s["lighting"])))
        t_cpu = time.perf_counter() - t0
        frac_rgb, frac_d, err = mismatch([t.cpu() for t in out_k], out_p)
        covered = (out_p[1] > 0).float().mean().item()
        log("parity", case=f"render_scene_{name}", batch=SCENE_PARITY_B,
            scene_faces=(1 + nd) * a.tri_pos.shape[2], launches=launches,
            rgb_mismatch=frac_rgb, depth_mismatch=frac_d, limit=RASTER_FRAC,
            max_abs_err=err, covered=covered, cpu_s=t_cpu)
        if frac_rgb > RASTER_FRAC or frac_d > RASTER_FRAC or not covered > 0:
            raise AssertionError(f"render_scene ({name}) on the card disagrees with the CPU")
        if name == "chunked" and launches["raster_cols"] != 2:
            raise AssertionError(f"the chunked scene did not render in two cols chunks: {launches}")
    phase_parity(model_f32, tex_assets, obs, init, ks, cls, case="refine_poses_textured")


def _percentile(xs, q):
    """The nearest-rank ``q``-th percentile of ``xs``."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, round(q / 100 * (len(xs) - 1)))]


def _serve_all(svc, calls):
    """Run ``calls`` (one list of request thunks per client thread) on
    client threads at once -> (per-thread lists of (result, seconds), wall
    seconds).  Any error of any request is raised."""
    import threading

    results = [[] for _ in calls]
    errors = []

    def client(i):
        try:
            for fn in calls[i]:
                t0 = time.perf_counter()
                out = fn()
                results[i].append((out, time.perf_counter() - t0))
        except Exception as e:  # raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(calls))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"a service request failed: {errors or 'client timed out'}")
    return results, wall


def phase_service(dev, card, rc, counts):
    """PoseRefinerService at the flagship config (synthetic_all_c2f: four
    procedural classes of at most 576 faces, the sort route; 480x640, K=4
    of which 2 coarse, bf16, fc_dim 1024), device batch B=128, from a
    port checkpoint of the headline's random weights written to a
    temporary output_dir.  8 clients send one 32-pose request each while
    4 clients send 8 one-pose requests each (every result against a
    direct refine_poses on the same rows, atol 1e-3); then 4 clients x 4
    requests of 128 poses for throughput, against the direct call's
    poses/s on one batch; last, the service's model and assets card
    against CPU at float32."""
    import tempfile

    import numpy as np

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.config import config_from_dict
    from deepim_tpu_torch.refine import refine_poses
    from deepim_tpu_torch.serve import PoseRefinerService
    from deepim_tpu_torch.train import checkpoint_dir, save_checkpoint

    try:
        import yaml  # noqa: F401
        has_yaml = True
    except ImportError:
        has_yaml = False
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = config_from_dict({**hl.SERVE_CONFIG, "output_dir": out_dir})
        weights = hl.random_model(4).state_dict()
        save_checkpoint(checkpoint_dir(cfg), 1, weights)
        t0 = time.perf_counter()
        svc = PoseRefinerService(cfg, load_checkpoint=True)
        setup_s = time.perf_counter() - t0
    try:
        loaded = svc.model.state_dict()
        if svc.step != 1 or any(not torch.equal(loaded[k].cpu(), v) for k, v in weights.items()):
            raise AssertionError("the service did not load its checkpoint")
        if svc.device != dev or svc.assets.tri_pos.device != dev:
            raise AssertionError(f"the service is on {svc.device}, not {dev}")
        faces = svc.assets.tri_pos.shape[2]
        log("serving", setup="service", yaml_importable=has_yaml, setup_s=setup_s,
            step=svc.step, classes=svc.names, faces=faces, lod=svc.assets.lod is not None,
            batch=svc.batch, iters=svc.num_iters, coarse_iters=cfg.test.coarse_iters)
        if faces >= rc._COLS_MIN_FACES_CROP:
            raise AssertionError("the flagship classes should take the sort route")

        obs, init, ks, cls = hl.headline_inputs(dev, svc.assets.num_classes, hl.B)
        host = [t.cpu().numpy() for t in (obs, init, ks, cls)]

        def direct():
            return refine_poses(svc.model, svc.assets, obs, init, ks, cls, num_iters=svc.num_iters,
                                out_size=hl.SIZE, coarse_iters=cfg.test.coarse_iters)

        ref = direct().cpu().numpy()

        def request(rows):  # a slice: the client sends views, as a caller's batch would be
            return lambda: (rows, svc.refine(*(a[rows] for a in host)))

        calls = [[request(slice(32 * i % hl.B, 32 * i % hl.B + 32))] for i in range(8)]
        calls += [[request(slice((8 * j + r) % hl.B, (8 * j + r) % hl.B + 1)) for r in range(8)]
                  for j in range(4)]
        before = copy.copy(svc.stats)
        rc.reset_launches()
        results, wall = _serve_all(svc, calls)
        counts["service"] = dict(rc.LAUNCHES)
        batches = svc.stats.device_batches - before.device_batches
        err = max(float(np.abs(out - ref[rows]).max())
                  for res in results for (rows, out), _ in res)
        single = [s * 1e3 for res in results[8:] for _, s in res]
        log("serving", run="mixed", requests=sum(map(len, calls)),
            poses=sum(len(out) for res in results for (_, out), _ in res),
            device_batches=batches, padded_slots=svc.stats.padded_slots - before.padded_slots,
            launches=counts["service"], max_abs_err_vs_direct=err, atol=PARITY_ATOL,
            one_pose_latency_ms_p50=_percentile(single, 50),
            one_pose_latency_ms_p99=_percentile(single, 99), wall_s=wall)
        if not err <= PARITY_ATOL:
            raise AssertionError("the service disagrees with a direct refine_poses")
        if (counts["service"]["raster_sorted"] != hl.K_ITERS * batches
                or counts["service"]["raster_cols"]):
            raise AssertionError(f"service batches missed the sorted kernel: {counts['service']}")

        # Throughput: 4 clients x 4 requests of B poses, against the direct
        # call on one batch already on the card.
        full = slice(None)
        _serve_all(svc, [[request(full)] * 4] * 4)  # warm
        before = copy.copy(svc.stats)
        _, wall = _serve_all(svc, [[request(full)] * 4] * 4)
        batches = svc.stats.device_batches - before.device_batches
        host_ms = (svc.stats.host_seconds - before.host_seconds) / batches * 1e3
        refine_ms = (svc.stats.refine_seconds - before.refine_seconds) / batches * 1e3
        direct_s = []
        for _ in range(4):
            t0 = time.perf_counter()
            direct()
            torch.cuda.synchronize()
            direct_s.append(time.perf_counter() - t0)
        # The worker's host work, in parts: stacking B frames, copying them.
        t0 = time.perf_counter()
        stacked = np.stack(list(host[0]))
        t1 = time.perf_counter()
        torch.from_numpy(stacked).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        service_rate = 16 * hl.B / wall
        direct_rate = hl.B / statistics.median(direct_s)
        log("serving", run="throughput", requests=16, poses=16 * hl.B, device_batches=batches,
            poses_per_s_service=service_rate, poses_per_s_direct_median4=direct_rate,
            service_over_direct=service_rate / direct_rate,
            worker_host_ms_per_batch=host_ms, worker_refine_ms_per_batch=refine_ms,
            host_share=host_ms / (host_ms + refine_ms), frames_stack_ms=(t1 - t0) * 1e3,
            frames_copy_ms=(t2 - t1) * 1e3, frames_bytes_per_batch=stacked.nbytes,
            direct_ms=[t * 1e3 for t in direct_s], card=repr(card))

        # The flagship meshes on the sort route, card against CPU at float32.
        model_f32 = copy.deepcopy(svc.model)
        model_f32.dtype = torch.float32
        rc.reset_launches()
        phase_parity(model_f32, svc.assets, obs, init, ks, cls, batch=FLAGSHIP_PARITY_B,
                     case="service_flagship")
        if rc.LAUNCHES["raster_sorted"] != hl.K_ITERS or rc.LAUNCHES["raster_cols"]:
            raise AssertionError(f"the flagship parity missed the sorted kernel: {rc.LAUNCHES}")
    finally:
        svc.close()


def video_scene(dev, assets, b, frames, generator_seed):
    """A shared stream of ``frames`` 480x640 frames with ``b`` objects of
    the headline classes drifting in x (each frame one render_scene, so
    the objects occlude each other) -> (frames (T, H, W, 3), depths (T,
    H, W), frame-0 poses (b, 3, 4), classes, ks)."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data.pairs import sample_poses_in_frustum
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.refine import render_scene

    g = torch.Generator(device=dev).manual_seed(generator_seed)
    k = make_intrinsics(*hl.LINEMOD_K, device=dev)
    gt = sample_poses_in_frustum(g, b, k, hl.SIZE, z_range=(0.6, 1.2))
    cls = torch.randint(0, assets.num_classes, (b,), generator=g, device=dev)
    rgb, depth = [], []
    for t in range(frames):
        poses = gt.clone()
        poses[:, 0, 3] += 0.003 * t
        r, d = render_scene(assets, cls[None], poses[None], torch.ones((1, b), dtype=torch.bool,
                            device=dev), k[None], hl.SIZE)
        rgb.append(r[0])
        depth.append(d[0])
    return torch.stack(rgb), torch.stack(depth), gt, cls, k.expand(b, 3, 3).contiguous()


def phase_selection_and_tracking(dev, card, rc, model, model_f32, assets, counts):
    """refine_multi_hypothesis at B=32 x 4 hypotheses (128 renders a step,
    the headline protocol, cols route), and refine_video over T=8 shared
    frames at B=32 (4 iterations, then 2 a frame), plain and with
    recovery armed; each run's launches counted from zero.  Then card
    against CPU at float32, TF32 off: score_poses (B=4, with and without
    observed depth), select_hypotheses on the same given hypotheses (4
    images x 4, margin 0, at least one challenger must win), plain
    refine_video (T=3, B=4)."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data.pairs import perturb_poses
    from deepim_tpu_torch.refine import (
        draw_hypotheses, gather_class, refine_multi_hypothesis, refine_poses, refine_video,
        score_poses, select_hypotheses)

    b, nh = 32, 4
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, b)
    common = dict(num_iters=hl.K_ITERS, out_size=hl.SIZE, coarse_iters=hl.COARSE_ITERS)
    refine_multi_hypothesis(model, assets, obs, init, ks, cls,
                            torch.Generator(device=dev).manual_seed(hl.SEED), **common)  # warm
    torch.cuda.synchronize()
    rc.reset_launches()
    t0 = time.perf_counter()
    best, scores = refine_multi_hypothesis(model, assets, obs, init, ks, cls,
                                           torch.Generator(device=dev).manual_seed(hl.SEED),
                                           num_hypotheses=nh, **common)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    counts["multi_hypothesis"] = dict(rc.LAUNCHES)
    hyps = draw_hypotheses(torch.Generator(device=dev).manual_seed(hl.SEED), init, nh)
    best_inf, _ = select_hypotheses(model, assets, obs, hyps, ks, cls,
                                    select_margin=float("inf"), **common)
    refined0 = refine_poses(model, assets, obs.repeat(nh, 1, 1, 1), hyps, ks.repeat(nh, 1, 1),
                            cls.repeat(nh), **common)[:b]
    picked = (best - refined0).abs().amax((1, 2)) > 0
    log("multi_hypothesis", batch=b, hypotheses=nh, renders_per_step=b * nh,
        launches=counts["multi_hypothesis"], scores_finite=bool(torch.isfinite(scores).all()),
        challengers_picked=int(picked.sum()), call_ms=call_ms, card=repr(card))
    if best.shape != (b, 3, 4) or scores.shape != (b, nh) or not torch.isfinite(scores).all():
        raise AssertionError("refine_multi_hypothesis: wrong shapes or scores not finite")
    if not torch.equal(best_inf, refined0):
        raise AssertionError("select_margin=inf did not return hypothesis 0 exactly")
    if counts["multi_hypothesis"]["raster_cols"] < hl.K_ITERS + 1:
        raise AssertionError(f"multi-hypothesis missed the cols kernel: {counts['multi_hypothesis']}")

    t_frames, iters_first, iters_rest, recover_iters = 8, 4, 2, 4
    frames, depths, gt, vcls, vks = video_scene(dev, assets, b, t_frames, hl.SEED + 2)
    g = torch.Generator(device=dev).manual_seed(hl.SEED + 3)
    init_v = perturb_poses(g, gt, rot_std_deg=5.0, trans_std=(0.005, 0.005, 0.01))
    init_v[::2, 0, 3] += 0.08  # half the tracks start grossly off
    video = dict(iters_first=iters_first, iters_rest=iters_rest, out_size=hl.SIZE,
                 obs_depths=depths)
    rc.reset_launches()
    plain = refine_video(model, assets, frames, init_v, vks, vcls, **video)
    torch.cuda.synchronize()
    counts["video"] = dict(rc.LAUNCHES)
    renders = iters_first + (t_frames - 1) * iters_rest
    ab = gather_class(assets, vcls)
    sc0 = score_poses(ab, frames[0].expand(b, *hl.SIZE, 3), init_v, vks, hl.SIZE,
                      obs_depth=depths[0].expand(b, *hl.SIZE))
    thresh = 0.5 * (sc0[1::2].mean() + sc0[::2].mean()).item()
    rc.reset_launches()
    (armed, armed_sc), peak_mib = peak_memory(lambda: refine_video(
        model, assets, frames, init_v, vks, vcls, recover_threshold=thresh,
        recover_iters=recover_iters, generator=torch.Generator(device=dev).manual_seed(hl.SEED),
        **video))
    counts["video_recovery"] = dict(rc.LAUNCHES)
    # Each re-acquisition renders recover_iters refine steps and one score.
    reacquired, rest = divmod(counts["video_recovery"]["raster_cols"] - renders - t_frames,
                              recover_iters + 1)
    plain_sc = score_poses(ab, frames[-1].expand(b, *hl.SIZE, 3), plain[-1], vks, hl.SIZE,
                           obs_depth=depths[-1].expand(b, *hl.SIZE))
    log("video", batch=b, frames=t_frames, iters_first=iters_first, iters_rest=iters_rest,
        launches_plain=counts["video"], launches_armed=counts["video_recovery"],
        threshold=thresh, frames_reacquired=reacquired,
        last_score_gross_plain=plain_sc[::2].mean().item(),
        last_score_gross_armed=armed_sc[-1, ::2].mean().item(), armed_peak_mib=peak_mib)
    for traj in (plain, armed):
        if traj.shape != (t_frames, b, 3, 4) or not torch.isfinite(traj).all():
            raise AssertionError("refine_video: wrong shape or poses not finite")
    if counts["video"]["raster_cols"] != renders or rest or reacquired < 1:
        raise AssertionError(f"video launches: {counts['video']}, {counts['video_recovery']}")

    # Card against CPU, float32.
    pb = PARITY_B
    cpu = torch.device("cpu")
    model_cpu = copy.deepcopy(model_f32).cpu()
    assets_cpu = assets.to(cpu)
    ab = gather_class(assets, vcls[:pb])
    args = (frames[0].expand(pb, *hl.SIZE, 3), init_v[:pb], vks[:pb])
    for depth in (None, depths[0].expand(pb, *hl.SIZE)):
        s_k = score_poses(ab, *args, hl.SIZE, obs_depth=depth).cpu()
        s_p = score_poses(ab.to(cpu), *(a.cpu() for a in args), hl.SIZE,
                          obs_depth=None if depth is None else depth.cpu())
        diff = (s_k - s_p).abs().max().item()
        log("parity", case="score_poses", depth=depth is not None, batch=pb,
            max_abs_err=diff, atol=1e-4)
        if not diff <= 1e-4 or not torch.isfinite(s_p).all():
            raise AssertionError("score_poses on the card disagrees with the CPU path")
    # Hypothesis 0 starts 5 cm off and the margin is 0, so that challengers
    # win and the gather of a non-zero winner runs on both sides.
    nb = 4
    hyps = draw_hypotheses(torch.Generator(device=dev).manual_seed(hl.SEED), init[:nb], nh)
    hyps[:nb, 0, 3] += 0.05
    sel = (obs[:nb], hyps, ks[:nb], cls[:nb])
    best_k, sc_k = select_hypotheses(model_f32, assets, *sel, **common, select_margin=0.0)
    best_p, sc_p = select_hypotheses(model_cpu, assets_cpu, *(a.cpu() for a in sel), **common,
                                     select_margin=0.0)
    diff = (best_k.cpu() - best_p).abs().max().item()
    winners = sc_p.argmax(1)
    same = torch.equal(sc_k.cpu().argmax(1), winners)
    log("parity", case="select_hypotheses", images=nb, hypotheses=nh, select_margin=0.0,
        max_pose_diff=diff, atol=PARITY_ATOL,
        max_score_diff=(sc_k.cpu() - sc_p).abs().max().item(), same_winners=same,
        winners=winners.tolist(), nonzero_winners=int((winners != 0).sum()))
    if not diff <= PARITY_ATOL or not same:
        raise AssertionError("select_hypotheses on the card disagrees with the CPU path")
    if not (winners != 0).any():
        raise AssertionError("select_hypotheses kept hypothesis 0 everywhere: no challenger "
                             "was gathered")
    vargs = (frames[:3], init_v[:pb], vks[:pb], vcls[:pb])
    traj_k = refine_video(model_f32, assets, *vargs, iters_first=2, iters_rest=1,
                          out_size=hl.SIZE).cpu()
    traj_p = refine_video(model_cpu, assets_cpu, *(a.cpu() for a in vargs), iters_first=2,
                          iters_rest=1, out_size=hl.SIZE)
    diff = (traj_k - traj_p).abs().max().item()
    moved = (traj_p[-1] - init_v[:pb].cpu()).abs().max().item()
    log("parity", case="refine_video", frames=3, batch=pb, max_pose_diff=diff,
        atol=PARITY_ATOL, moved=moved)
    if not diff <= PARITY_ATOL or not moved > 1e-3:
        raise AssertionError("refine_video on the card disagrees with the CPU path")


# bf16 dense tensor-core peak of one H100 SXM (NVIDIA's data sheet, 700 W).
BF16_FLOPS_PER_S = 989e12
TRAIN_STEPS = 20  # timed fused steps at each size
OVERFIT_STEPS = 80  # tests/test_train.py §test_micro_overfit
# synthetic_small.yaml through cli.train (300, 350 until the on-disk phase came)
SMALL_STEPS, SMALL_RESUME = 150, 200
TRAINED_EVAL_N = 512  # cli.test on the checkpoint cli.train wrote
TRAIN_PARITY_B = 2
TRAIN_LOGS: dict[str, str] = {}  # phase 12's train_log.jsonl, by config
TRAIN_RTOL, GRAD_FRAC, PARAM_ATOL = 1e-4, 1e-3, 1e-6
# The card's float32 gradient against its float64 one at train_iter 1:
# cuDNN's float32 backward missed by 2.78e-2 of a leaf's max (conv6_1) at
# 480x640 on an H100; a wrong kernel misses by the order of the leaf.
F32_GRAD_FRAC = 1e-1
# float64 at train_iter 2, card against CPU: the second iteration's zoom
# box and k_zoom round one float32 ulp apart by device, and its crop then
# differs in ~11k depth pixels; the gradient missed by 1.99e-2 of a
# leaf's max (deconv5) on an H100, and by 1.35e-6 with the CPU's zoom
# box, k_zoom and pose handed to the card.
ITER2_GRAD_FRAC = 5e-2


def network_flops(model, h: int, w: int) -> tuple[float, float]:
    """(forward, forward + backward) FLOPs of one sample and iteration,
    counted from the layer shapes: 2 per multiply-add of every conv,
    transposed conv and dense layer.  The backward takes twice the
    forward (input and weight gradients), less conv1's input gradient,
    which nothing needs."""
    from deepim_tpu_torch.models.flownet import DECODER, ENCODER, SKIPS

    fwd, sizes = 0.0, {}
    for name, cout, k, s in ENCODER:
        h, w = -(-h // s), -(-w // s)
        sizes[name] = (h, w)
        flops = 2.0 * getattr(model, name).in_channels * cout * k * k * h * w
        fwd += flops
        if name == "conv1":
            conv1 = flops
    if model.with_flow or model.with_mask:
        h, w = sizes["conv6_1"]
        fwd += 2.0 * model.predict_flow6.in_channels * 2 * 9 * h * w
        for lvl, cout in DECODER:
            # a 4x4 transposed conv: 16 taps for every input pixel
            fwd += 2.0 * getattr(model, f"deconv{lvl}").in_channels * cout * 16 * h * w
            fwd += 2.0 * 2 * 2 * 16 * h * w
            h, w = sizes[SKIPS[lvl]]
            fwd += 2.0 * getattr(model, f"predict_flow{lvl}").in_channels * 2 * 9 * h * w
        if model.with_mask:
            fwd += 2.0 * (model.mask_conv.in_channels * 64 + 64) * 9 * h * w
    for fc in (model.fc1, model.fc2, model.fc_rot, model.fc_trans):
        fwd += 2.0 * fc.in_features * fc.out_features
    return fwd, 3.0 * fwd - conv1


def phase_training(dev, card, rc, counts):
    """Training at the flagship config (``headline.TRAIN_CONFIG``,
    synthetic_all: B=32, 480x640, train_iter 2, flow + mask heads, bf16,
    Adam): the fused synthesize-and-train step timed over TRAIN_STEPS
    steps at 480x640 and at the coarse size 240x320, the ms of its parts,
    its launches, peak memory and model FLOPs; the micro-overfit; a few
    hundred steps of synthetic_small.yaml through ``cli.train.main`` and
    its ``--resume``; one train step card against CPU."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.config import config_from_dict
    from deepim_tpu_torch.data import synthetic_batch
    from deepim_tpu_torch.ops.flow_gt import calc_flow
    from deepim_tpu_torch.ops.zoom import zoom_image_batch
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.refine.refiner import build_network_inputs, gather_class
    from deepim_tpu_torch.train import (
        compute_losses, init_state, make_lr_schedule, make_model, make_synthetic_train_step)
    from deepim_tpu_torch.train.train import apply_gradients

    cfg = config_from_dict(hl.TRAIN_CONFIG)
    t, d, n = cfg.train, cfg.dataset, cfg.network
    assets, _, _ = load_assets_and_names(cfg, device=dev)
    model = make_model(cfg, assets.num_classes,
                       generator=torch.Generator().manual_seed(hl.SEED)).to(dev)
    state = init_state(cfg, model)
    k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
    g = torch.Generator(device=dev).manual_seed(hl.SEED)
    faces = assets.tri_pos.shape[2]
    expect_sorted = 1 + t.train_iter  # the observed frame, then one crop an iteration
    for size in (hl.SIZE, hl.COARSE):
        cfg_s = dataclasses.replace(cfg, network=dataclasses.replace(
            n, input_height=size[0], input_width=size[1]))
        step = make_synthetic_train_step(model, assets, cfg_s, k_cam)
        step(state, g), step(state, g)  # warm (cuDNN algorithm choice, allocator)
        torch.cuda.synchronize()
        rc.reset_launches()
        step(state, g)
        torch.cuda.synchronize()
        launches = dict(rc.LAUNCHES)
        counts[f"train_{size[0]}x{size[1]}"] = launches
        if launches["raster_sorted"] != expect_sorted or launches["raster_cols"]:
            raise AssertionError(f"a training render missed the sorted kernel: {launches}")
        _, peak = peak_memory(lambda: step(state, g))
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            _, metrics = step(state, g)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TRAIN_STEPS
        metrics = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"training metrics are not finite: {metrics}")
        fwd, fwd_bwd = network_flops(model, *size)
        step_flops = fwd_bwd * t.batch_size * t.train_iter
        log("train", config="synthetic_all", size=f"{size[0]}x{size[1]}", batch=t.batch_size,
            train_iter=t.train_iter, dtype="bf16", faces=faces,
            steps_per_s=1.0 / step_s, samples_per_s=t.batch_size / step_s,
            step_ms=step_s * 1e3, peak_mib=peak, sorted_launches=launches["raster_sorted"],
            cols_launches=launches["raster_cols"], expected_sorted=expect_sorted,
            fwd_gflop_per_sample_iter=fwd / 1e9, step_tflop=step_flops / 1e12,
            mfu_bf16_dense=step_flops / step_s / BF16_FLOPS_PER_S,
            loss=metrics["loss"], grad_norm=metrics["grad_norm"], card=repr(card))

    # The parts of one full-size step, each timed alone with CUDA events.
    image = (d.image_height, d.image_width)
    out_size = hl.SIZE
    parts = {"synthesis": lambda: synthetic_batch(g, assets, t.batch_size, k_cam, image)}
    batch = parts["synthesis"]()
    ab = gather_class(assets, batch["class_idx"])

    def inputs():
        return build_network_inputs(model, ab, batch["obs_rgb"], batch["pose_src"],
                                    batch["k"], out_size, obs_mask=batch["obs_mask"],
                                    obs_depth=batch["obs_depth"])

    ni = inputs()

    def flow_gt():
        with torch.no_grad():
            crop = zoom_image_batch(batch["obs_depth"][..., None], ni.box, out_size,
                                    "nearest")[..., 0]
            return calc_flow(ni.ren_depth, batch["pose_src"], batch["pose_tgt"], ni.k_zoom,
                             crop, occlusion_stride=t.flow_occ_stride)

    def fwd_bwd():
        state.optimizer.zero_grad(set_to_none=False)
        compute_losses(model, assets, batch, cfg)[0].backward()

    sched = make_lr_schedule(cfg)
    parts.update(network_inputs=inputs, flow_gt=flow_gt, losses_fwd_bwd=fwd_bwd,
                 optimizer=lambda: apply_gradients(state, cfg, sched))
    ms = {}
    for name, fn in parts.items():
        fn()
        ms[name] = ms_per_call(fn, 5)
    log("train_parts", size=f"{out_size[0]}x{out_size[1]}", batch=t.batch_size, per="call",
        synthesis_ms=ms["synthesis"], network_inputs_ms_per_iter=ms["network_inputs"],
        flow_gt_ms_per_iter=ms["flow_gt"], losses_fwd_bwd_ms=ms["losses_fwd_bwd"],
        optimizer_ms=ms["optimizer"],
        note="losses_fwd_bwd holds train_iter x (network_inputs + flow_gt) besides "
             "the network")

    phase_micro_overfit(dev, card)
    phase_train_cli(dev, card)
    phase_train_parity(dev, card, assets)


def phase_micro_overfit(dev, card):
    """tests/test_train.py §test_micro_overfit on the card: a fixed batch,
    Adam at lr 3e-4, OVERFIT_STEPS steps, flow and mask heads off, its
    tiny config (64x128, B=4, fc_dim 64, float32, box and sphere)."""
    from deepim_tpu_torch.config import config_from_dict
    from deepim_tpu_torch.data import synthetic_batch
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.raster.mesh import box_mesh, icosphere_mesh
    from deepim_tpu_torch.refine import build_assets
    from deepim_tpu_torch.train import init_state, make_model, make_train_step

    h, w = 64, 128
    cfg = config_from_dict({
        "network": {"input_height": h, "input_width": w, "dtype": "float32", "fc_dim": 64,
                    "with_flow": False, "with_mask": False},
        "dataset": {"image_height": h, "image_width": w, "objects": ["box", "icosphere"]},
        "train": {"batch_size": 4, "warmup_steps": 0, "lr": 3e-4, "optimizer": "adam",
                  "weight_decay": 0.0, "w_flow": 0.0, "w_mask": 0.0}})
    assets = build_assets([box_mesh((0.08, 0.1, 0.06)), icosphere_mesh(0.05)],
                          num_points=64, device=dev)
    model = make_model(cfg, 2, generator=torch.Generator().manual_seed(0)).to(dev)
    state = init_state(cfg, model)
    step = make_train_step(model, assets, cfg)
    k = make_intrinsics(120.0, 120.0, 64.0, 32.0, device=dev)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(5), assets, 4, k, (h, w))
    losses, rot = [], []
    for _ in range(OVERFIT_STEPS):
        _, m = step(state, batch)
        losses.append(m["loss"])
        rot.append(m["rot_err_deg_0"])
    losses, rot = torch.stack(losses).tolist(), torch.stack(rot).tolist()
    ok = min(losses) < 0.5 * losses[0] and min(rot) < 0.7 * rot[0]
    log("micro_overfit", steps=OVERFIT_STEPS, loss_first=losses[0], loss_min=min(losses),
        loss_last=losses[-1], rot_err_deg_first=rot[0], rot_err_deg_min=min(rot),
        need="min(loss) < 0.5 x first, min(rot_err_deg_0) < 0.7 x first", ok=ok)
    if not ok:
        raise AssertionError("the micro-overfit's loss did not fall")


def phase_train_cli(dev, card):
    """SMALL_STEPS fresh-batch steps of experiments/cfgs/synthetic_small.yaml
    (192x256, B=32) through ``python -m deepim_tpu_torch.cli.train`` 's
    main into a temporary output_dir, logging every step; then
    ``--resume`` to SMALL_RESUME steps from the checkpoint it wrote."""
    import io
    import tempfile

    import yaml

    from deepim_tpu_torch.cli import train as cli
    from deepim_tpu_torch.train import checkpoint_dir, latest_step
    from deepim_tpu_torch.config import config_from_dict

    with open(ROOT / "experiments/cfgs/synthetic_small.yaml") as f:
        spec = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as tmp:
        spec["output_dir"] = tmp
        spec["train"]["log_every"] = 1
        path = Path(tmp) / "synthetic_small.yaml"
        path.write_text(yaml.safe_dump(spec))
        args = ["--cfg", str(path), "--device", str(dev)]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(args + ["--num-steps", str(SMALL_STEPS)])
        run_s = time.perf_counter() - t0
        with contextlib.redirect_stdout(out):
            cli.main(args + ["--num-steps", str(SMALL_RESUME), "--resume"])
        log_path = Path(tmp) / spec["experiment"] / "train_log.jsonl"
        TRAIN_LOGS["synthetic_small"] = log_path.read_text()  # phase 19 plots it
        recs = [json.loads(line) for line in log_path.read_text().splitlines()]
        ckpt = checkpoint_dir(config_from_dict(spec))
        resumed = f"resumed from step {SMALL_STEPS}" in out.getvalue()
        steps = [r["step"] for r in recs]
        first = statistics.mean(r["loss"] for r in recs[:50])
        last = statistics.mean(r["loss"] for r in recs[SMALL_STEPS - 50:SMALL_STEPS])
        log("train_cli", config="synthetic_small", batch=spec["train"]["batch_size"],
            size=f"{spec['network']['input_height']}x{spec['network']['input_width']}",
            steps=SMALL_STEPS, seconds=run_s, mean_loss_first50=first, mean_loss_last50=last,
            resumed=resumed, resumed_to=steps[-1], latest_checkpoint=latest_step(ckpt),
            last_line=out.getvalue().strip().splitlines()[-2])
        if steps != list(range(1, SMALL_RESUME + 1)) or not resumed:
            raise AssertionError(f"--resume did not continue the run: {steps[-5:]}")
        if latest_step(ckpt) != SMALL_RESUME or not last < first:
            raise AssertionError("synthetic_small: no checkpoint, or the loss did not fall")

        # The trained checkpoint scored before its directory goes: INIT
        # against the last iteration, each with its 95 % interval (printed,
        # not gated).
        from deepim_tpu_torch.cli import test as cli_test

        rows = {}
        for tag, extra in (("init", ["--no-refine"]), ("refined", [])):
            _, eval_s, _, _ = run_cli(cli_test.main, ["--cfg", str(path), "--device", str(dev),
                                                      "--num-samples", str(TRAINED_EVAL_N),
                                                      *extra])
            res = json.loads((Path(tmp) / spec["experiment"] / "eval_results.json").read_text())
            rows[tag] = {k: f"{res['mean'][k]:.2f}+-{res['mean']['ci95'][k]:.2f}"
                         for k in ("add(-s)_0.1d", "5deg_5cm", "proj2d_5px")}
        log("trained_eval", config="synthetic_small", step=SMALL_RESUME, samples=TRAINED_EVAL_N,
            init=rows["init"], iter4=rows["refined"], eval_s=eval_s)


@contextlib.contextmanager
def recording_step_inputs(record: list, shared: list | None = None):
    """Append to ``record``, per iteration of ``compute_losses``, what it
    computes under no_grad: the pose it refines from, the zoom box and
    k_zoom (``compute_zoom_box``, ``zoom_intrinsics``) with the network
    input and renders (``build_network_inputs``), the observation's
    nearest depth and mask crops (``zoom_image_batch``), the flow GT
    (``calc_flow``) and the updated pose (``apply_delta``).  Given
    ``shared`` (another run's record), the zoom box, k_zoom and updated
    pose of each iteration are that run's: the crops are rendered and
    sampled from the same float32 values."""
    from deepim_tpu_torch.refine import refiner
    from deepim_tpu_torch.train import train as tr

    home = {"build_network_inputs": tr, "zoom_image_batch": tr, "calc_flow": tr,
            "apply_delta": tr, "compute_zoom_box": refiner, "zoom_intrinsics": refiner}
    real = {n: getattr(mod, n) for n, mod in home.items()}
    pending = {}

    def like(value, out):
        if isinstance(out, tuple):
            return type(out)(*(like(v, o) for v, o in zip(value, out)))
        return value.to(device=out.device, dtype=out.dtype)

    def wrap(name):
        def call(*args, **kwargs):
            out = real[name](*args, **kwargs)
            if name in ("compute_zoom_box", "zoom_intrinsics"):
                if shared is not None:
                    out = like(shared[len(record)][name], out)
                pending[name] = out
            elif name == "build_network_inputs":
                record.append({"pose": args[3], "ni": out, "crops": [], **pending})
                pending.clear()
            elif name == "zoom_image_batch":
                record[-1]["crops"].append(out)
            elif name == "calc_flow":
                record[-1]["flow"] = out
            else:
                if shared is not None:
                    out = like(shared[len(record) - 1]["pose_new"], out)
                record[-1]["pose_new"] = out.detach()
            return out
        return call

    for name, mod in home.items():
        setattr(mod, name, wrap(name))
    try:
        yield
    finally:
        for name, mod in home.items():
            setattr(mod, name, real[name])


def step_input_diffs(card_rec: list, cpu_rec: list) -> list[dict]:
    """Card against CPU, per iteration: how far the pose, the zoom box
    (origin in pixels, scale relative) and k_zoom moved, and how many pixels of the network input
    (any channel off by more than 1e-6), the rendered depth, the two
    nearest crops and the flow GT's valid mask differ."""
    def cpu64(x):
        return x.detach().cpu().double()

    rows = []
    for it, (a, b) in enumerate(zip(card_rec, cpu_rec)):
        (flow_a, valid_a), (flow_b, valid_b) = a["flow"], b["flow"]
        both = valid_a.cpu() & valid_b.cpu()
        x_off = (cpu64(a["ni"].x) - cpu64(b["ni"].x)).abs().amax(dim=-1)
        rows.append(dict(
            iteration=it,
            pose_max_diff=float((cpu64(a["pose"]) - cpu64(b["pose"])).abs().max()),
            box_origin_max_diff_px=max(float((cpu64(getattr(a["ni"].box, f))
                                              - cpu64(getattr(b["ni"].box, f))).abs().max())
                                       for f in ("x0", "y0")),
            box_scale_max_rel_diff=max(float(((cpu64(getattr(a["ni"].box, f))
                                               - cpu64(getattr(b["ni"].box, f)))
                                              / cpu64(getattr(b["ni"].box, f))).abs().max())
                                       for f in ("sx", "sy")),
            k_zoom_max_diff=float((cpu64(a["ni"].k_zoom) - cpu64(b["ni"].k_zoom)).abs().max()),
            pixels=x_off.numel(), x_max_abs_diff=float(x_off.max()),
            x_pixels_off=int((x_off > 1e-6).sum()),
            ren_depth_pixels_off=int(((cpu64(a["ni"].ren_depth)
                                       - cpu64(b["ni"].ren_depth)).abs() > 1e-6).sum()),
            obs_depth_crop_pixels_off=int((a["crops"][0].cpu() != b["crops"][0].cpu()).sum()),
            obs_mask_crop_pixels_off=int((a["crops"][1].cpu() != b["crops"][1].cpu()).sum()),
            flow_valid_pixels_off=int((valid_a.cpu() != valid_b.cpu()).sum()),
            flow_max_diff_where_both_valid=float(
                ((cpu64(flow_a) - cpu64(flow_b)).abs() * both[..., None]).max())))
    return rows


def grad_err(got: dict, want: dict) -> tuple[float, str]:
    """(max over leaves of the largest gradient difference over that
    leaf's max abs, the leaf where it is)."""
    return max((float((got[n].double() - v.double()).abs().max())
                / max(float(v.abs().max()), 1e-30), n) for n, v in want.items())


def phase_train_parity(dev, card, assets):
    """One train step on the card (kernels, cuDNN) against the CPU (plain
    versions) at B=TRAIN_PARITY_B, 480x640, the flagship config without
    warmup (the update runs at lr 3e-4): the same bridged initial weights
    (pose heads given noise so every layer learns), the same batch made on
    the CPU, TF32 off.

    - float32 at the flagship's train_iter 2: the losses and monitors
      agree within rtol 1e-4.  Its card-against-CPU gradients and updated
      params are printed, not held: float32 backward algorithms miss the
      float64 gradient by up to 2.8 % (cuDNN) and 12 % (oneDNN) of a
      layer's largest entry here, and Adam's first update, ~lr * sign(g),
      turns a sign that differs into 2 lr.
    - The card's float32 gradient against the card's float64 gradient at
      train_iter 1 (the same input): within F32_GRAD_FRAC of each leaf's
      max abs.
    - float64 at train_iter 1: the metrics, the gradient norm and each
      gradient within 1e-3 of its leaf's max abs.
    - float64 at train_iter 2: the no-grad inputs of each iteration card
      against CPU (pose, zoom box, k_zoom, and the pixels that differ in
      the network input, rendered depth, nearest crops and flow-GT valid
      mask) printed; the metrics within rtol 1e-4 and each gradient
      within ITER2_GRAD_FRAC of its leaf's max abs.  Run again with the
      CPU's zoom box, k_zoom and updated pose of each iteration handed to
      the card (its crops then render from the same float32 values): the
      metrics, the gradient norm and each gradient within 1e-3.
    - Adam on the card from the CPU's float32 gradients gives the CPU's
      params within 1e-6."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.config import config_from_dict
    from deepim_tpu_torch.data import synthetic_batch
    from deepim_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.train import compute_losses, init_state, make_lr_schedule, make_model
    from deepim_tpu_torch.train.train import apply_gradients

    spec = copy.deepcopy(hl.TRAIN_CONFIG)
    spec.setdefault("network", {})["dtype"] = "float32"
    spec["train"].update(batch_size=TRAIN_PARITY_B, warmup_steps=0)
    cfg = config_from_dict(spec)
    d, size = cfg.dataset, f"{cfg.network.input_height}x{cfg.network.input_width}"
    g = torch.Generator().manual_seed(hl.SEED)
    sd = make_model(cfg, assets.num_classes, generator=g).state_dict()
    for head in ("fc_rot", "fc_trans"):
        for kind in ("weight", "bias"):
            sd[f"{head}.{kind}"] = sd[f"{head}.{kind}"] + hl.HEAD_SCALE * torch.randn(
                sd[f"{head}.{kind}"].shape, generator=g)
    sd = flax_to_torch(torch_to_flax(sd))
    assets_cpu = assets.to("cpu")
    k = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device="cpu")
    batch = synthetic_batch(g, assets_cpu, TRAIN_PARITY_B, k, (d.image_height, d.image_width))

    def fresh(device, dtype):
        m = make_model(cfg, assets.num_classes)
        m.load_state_dict(sd)
        m = m.to(device=device, dtype=dtype)
        m.dtype = dtype
        return m, init_state(cfg, m)

    def one_step(device, dtype, train_iter, record=None, shared=None):
        cfg_s = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                   train_iter=train_iter))
        m, state = fresh(device, dtype)
        a = assets if device == dev else assets_cpu
        t0 = time.perf_counter()
        with (recording_step_inputs(record, shared) if record is not None
              else contextlib.nullcontext()):
            loss, metrics = compute_losses(m, a, {k: v.to(device) for k, v in batch.items()},
                                           cfg_s)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters()}
        metrics["grad_norm"] = apply_gradients(state, cfg_s, make_lr_schedule(cfg_s))
        metrics = {k: float(v) for k, v in metrics.items()}
        params = {n: p.detach().cpu() for n, p in m.named_parameters()}
        return metrics, grads, params, time.perf_counter() - t0

    held, card_grads, cpu_f32 = {}, {}, None
    for dtype, train_iter, shared in ((torch.float32, 2, False), (torch.float64, 1, False),
                                      (torch.float64, 2, False), (torch.float64, 2, True)):
        name = "float32" if dtype == torch.float32 else "float64"
        rec_card, rec_cpu = [], []
        m_cpu, g_cpu, p_cpu, t_cpu = one_step("cpu", dtype, train_iter, rec_cpu)
        m_card, g_card, p_card, t_card = one_step(dev, dtype, train_iter, rec_card,
                                                  rec_cpu if shared else None)
        if not shared:
            card_grads[name, train_iter] = g_card
        cpu_f32 = cpu_f32 or (g_cpu, p_cpu)
        rel = {k: abs(m_card[k] - v) / max(abs(v), 1e-12) for k, v in m_cpu.items()}
        forward_err = max(v for k, v in rel.items() if k != "grad_norm")
        g_err, g_leaf = grad_err(g_card, g_cpu)
        diffs = [(p_card[n] - v).abs() for n, v in p_cpu.items()]
        param_err = max(float(x.max()) for x in diffs)
        tag = f"{name}_iter{train_iter}" + ("_shared_zoom" if shared else "")
        grad_frac = (ITER2_GRAD_FRAC if (name, train_iter, shared) == ("float64", 2, False)
                     else GRAD_FRAC)
        held[f"{tag}_metrics_rtol_1e-4"] = forward_err <= TRAIN_RTOL
        held[f"{tag}_grad_norm_rtol_1e-4"] = rel["grad_norm"] <= TRAIN_RTOL
        held[f"{tag}_grads_{grad_frac:g}_of_leaf_max"] = g_err <= grad_frac
        held[f"{tag}_params_after_adam_1e-6"] = param_err <= PARAM_ATOL
        log("train_parity", dtype=name, train_iter=train_iter, batch=TRAIN_PARITY_B,
            card_takes_cpu_zoom_and_poses=shared, size=size, tf32=False,
            loss_card=m_card["loss"], loss_cpu=m_cpu["loss"],
            max_loss_metric_rel_err=forward_err, grad_norm_rel_err=rel["grad_norm"],
            max_grad_err_over_leaf_max=g_err, at_leaf=g_leaf,
            max_param_err_after_adam=param_err,
            params_off_by_more_than_1e6th=sum(int((x > PARAM_ATOL).sum()) for x in diffs),
            params=sum(x.numel() for x in diffs), card_s=t_card, cpu_s=t_cpu)
        for row in step_input_diffs(rec_card, rec_cpu):
            log("train_parity_inputs", dtype=name, train_iter=train_iter,
                card_takes_cpu_zoom_and_poses=shared, **row)
        del g_cpu, p_card, p_cpu, diffs
    # The card's float32 backward against its own float64 one.
    card_grads["float32", 1] = one_step(dev, torch.float32, 1)[1]
    f32_err = {it: grad_err(card_grads["float32", it], card_grads["float64", it])
               for it in (1, 2)}
    held[f"card_float32_vs_float64_iter1_grads_{F32_GRAD_FRAC:g}_of_leaf_max"] = (
        f32_err[1][0] <= F32_GRAD_FRAC)
    log("train_parity", case="card_float32_vs_card_float64",
        iter1_max_grad_err_over_leaf_max=f32_err[1][0], iter1_at_leaf=f32_err[1][1],
        iter2_max_grad_err_over_leaf_max=f32_err[2][0], iter2_at_leaf=f32_err[2][1])
    del card_grads
    # The optimizer alone: the card's Adam on the CPU's float32 gradients.
    g_cpu, p_cpu = cpu_f32
    m, state = fresh(dev, torch.float32)
    for n, p in m.named_parameters():
        p.grad.copy_(g_cpu[n])
    apply_gradients(state, cfg, make_lr_schedule(cfg))
    adam_err = max(float((p.detach().cpu() - p_cpu[n]).abs().max())
                   for n, p in m.named_parameters())
    moved = max(float((p_cpu[n] - sd[n]).abs().max()) for n in p_cpu)
    held["adam_on_shared_grads_1e-6"] = adam_err <= PARAM_ATOL
    gated = ("float32_iter2_metrics_rtol_1e-4",
             f"card_float32_vs_float64_iter1_grads_{F32_GRAD_FRAC:g}_of_leaf_max",
             "float64_iter1_metrics_rtol_1e-4", "float64_iter1_grad_norm_rtol_1e-4",
             f"float64_iter1_grads_{GRAD_FRAC:g}_of_leaf_max",
             "float64_iter2_metrics_rtol_1e-4",
             f"float64_iter2_grads_{ITER2_GRAD_FRAC:g}_of_leaf_max",
             "float64_iter2_shared_zoom_metrics_rtol_1e-4",
             "float64_iter2_shared_zoom_grad_norm_rtol_1e-4",
             f"float64_iter2_shared_zoom_grads_{GRAD_FRAC:g}_of_leaf_max",
             "adam_on_shared_grads_1e-6")
    log("train_parity", case="adam_on_shared_grads", max_param_err=adam_err, moved=moved,
        held=held, gated=list(gated))
    if not all(held[k] for k in gated) or not moved > 1e-5:
        raise AssertionError(f"a train step on the card disagrees with the CPU path: {held}")


# The evaluator card against CPU: each per-sample error within rtol, with
# an atol by unit (metres, degrees, pixels).
EVAL_RTOL = 1e-5
EVAL_ATOL = {"add": 1e-7, "adds": 1e-7, "add_sym": 1e-7, "trans_m": 1e-7, "rot_deg": 1e-5,
             "proj2d_px": 1e-4}
EVAL_PARITY_ROWS = 256  # the flagship trajectory's first rows, scored on both devices
EVAL_PARITY_B = 4  # one eval batch through the eval loop on both devices
EVAL_TRAJ_ATOL = 1e-5  # refine_poses card against CPU reads ~5e-7 (phase 4)
BOP_ATOL = 1e-6
EVAL_SAMPLES, HYP_SAMPLES = 2048, 256  # cli.test's default set; the gross-init run
OCC_SAMPLES, OCC_DENSE_SAMPLES = 256, 64
TRACK_FRAMES, TRACK_WINDOW = 8, 4
LABEL_TIE_M = 1e-5  # labels may differ where two objects' depths are this close


def run_cli(main_fn, argv):
    """``main_fn(argv)`` with its stdout captured -> (text, seconds, the
    raster launches it made, its peak device MiB above what was held)."""
    import io

    from deepim_tpu_torch.raster import raster_cuda as rc

    out = io.StringIO()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rc.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = main_fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if code:
        raise AssertionError(f"{argv} exited {code}:\n{out.getvalue()[-2000:]}")
    return (out.getvalue(), seconds, dict(rc.LAUNCHES),
            (torch.cuda.max_memory_allocated() - base) / 2**20)


def experiment_yaml(tmp: str, cfg_file: str, **overrides) -> str:
    """experiments/cfgs/<cfg_file> with output_dir in ``tmp`` (and the
    dataset fields of ``overrides``), written to ``tmp`` -> its path."""
    import yaml

    with open(ROOT / "experiments" / "cfgs" / cfg_file) as f:
        spec = yaml.safe_load(f)
    spec["output_dir"] = tmp
    spec["dataset"].update(overrides)
    if overrides:
        spec["experiment"] += "_" + "_".join(overrides)
    path = Path(tmp) / cfg_file
    path.write_text(yaml.safe_dump(spec))
    return str(path)


def _number(pattern: str, text: str) -> float:
    import re

    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"no {pattern!r} in:\n{text[-2000:]}")
    return float(m.group(1))


def _row(text: str, tag: str) -> str:
    return next(ln for ln in text.splitlines() if ln.startswith(tag))


def adds_broadcast(points, pose_est, pose_gt, point_block):
    """ADD-S with its cross term as the broadcast multiply-sum of
    ``geometry/se3.py §_mm``, the form ``pose_errors.adds_error`` had
    before its three-products rewrite: kept here to measure what its
    (chunk, N, 3, block) product held."""
    from deepim_tpu_torch.geometry.pose_errors import _posed
    from deepim_tpu_torch.geometry.se3 import _mm

    p_est, p_gt = _posed(points, pose_est), _posed(points, pose_gt)
    center = p_gt.mean(-2, keepdim=True)
    p_est, p_gt = p_est - center, p_gt - center
    sq_gt = (p_gt * p_gt).sum(-1)
    min_d2 = torch.full_like(sq_gt, math.inf)
    for i0 in range(0, p_est.shape[-2], point_block):
        block = p_est[..., i0:i0 + point_block, :]
        cross = _mm(p_gt, block.transpose(-1, -2))
        d2 = sq_gt[..., :, None] + (block * block).sum(-1)[..., None, :] - 2.0 * cross
        min_d2 = torch.minimum(min_d2, d2.clamp_min(0.0).amin(-1))
    return min_d2.sqrt().mean(-1)


def _near_thresholds(errs, diam, cls, symmetric, th) -> int:
    """Samples whose error lies within the card-against-CPU tolerance of
    one of the table's thresholds (a comparison that may flip)."""
    import numpy as np

    near = np.zeros(len(cls), bool)
    add_like = np.where(np.asarray(symmetric)[cls], errs["adds"], errs["add"])
    for key, vals, thr in (("add", add_like, th.add_frac * diam[cls]),
                           ("add", errs["add"], th.add_frac * diam[cls]),
                           ("adds", errs["adds"], th.add_frac * diam[cls]),
                           ("rot_deg", errs["rot_deg"], th.rot_deg),
                           ("trans_m", errs["trans_m"], th.trans_m),
                           ("proj2d_px", errs["proj2d_px"], th.proj_px)):
        near |= np.abs(vals - thr) <= EVAL_ATOL[key] + EVAL_RTOL * np.abs(thr)
    return int(near.sum())


def phase_evaluation(dev, card, rc, counts):
    """Evaluation at full width: ``cli.test.main`` at the flagship config
    (experiments/cfgs/synthetic_all_c2f.yaml: 480x640, test B=32, K=4 of
    which 2 coarse at 240x320, bf16, four classes of at most 576 faces,
    2,048 samples) from a port checkpoint of the phases' seed-7 random
    model, with --save-poses; the evaluator alone on its 5 x 2,048 rows
    (ms, peak MiB, and the peak of the ADD-S cross term as a broadcast
    product); --no-refine (the same INIT row) with --vis; --hypotheses 4
    at gross inits; the occlusion set of occlusion_small.yaml, and of it
    on the dense classes of synthetic_dense.yaml; then card against CPU:
    the evaluator on the first 256 rows of the flagship trajectory, and one
    eval batch (B=4, float32) through the eval loop."""
    import tempfile

    import numpy as np

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.eval import (
        EvalThresholds, compute_pose_errors, evaluate_poses, read_bop_csv)
    from deepim_tpu_torch.geometry.pose_errors import adds_error
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES
    from deepim_tpu_torch.train import checkpoint_dir, save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = experiment_yaml(tmp, "synthetic_all_c2f.yaml")
        cfg = update_config(path)
        save_checkpoint(checkpoint_dir(cfg), hl.SEED, hl.random_model(4).state_dict())
        dev_arg = ["--device", str(dev)]
        bs, k_iters = cfg.test.batch_size, cfg.test.test_iter
        n = EVAL_SAMPLES
        text, seconds, launches, peak = run_cli(
            cli_test.main, ["--cfg", path, *dev_arg, "--save-poses", "--num-samples", str(n)])
        batches = n // bs
        counts["eval_flagship"] = launches
        out_dir = Path(tmp) / cfg.experiment
        npz = np.load(out_dir / "refined_poses.npz")
        traj, gt, cls, ks = npz["traj"], npz["pose_gt"], npz["class_idx"], npz["k"]
        bop = read_bop_csv(str(out_dir / "bop_results.csv"))
        bop_err = float(np.abs(bop["poses"] - traj[-1]).max())
        expect_sorted = batches * (1 + k_iters)  # the observed frame, then one crop an iteration
        log("eval", config=cfg.experiment, samples=n, batch=bs, iters=k_iters,
            coarse_iters=cfg.test.coarse_iters, dtype=cfg.network.dtype,
            refine_poses_per_s=_number(r"\(([\d.]+) poses/s", text), seconds=seconds,
            evaluate_s=_number(r"poses in ([\d.]+)s", text), peak_mib=peak,
            sorted_per_batch=launches["raster_sorted"] / batches,
            cols_per_batch=launches["raster_cols"] / batches,
            predicted_sorted_per_batch=1 + k_iters, predicted_cols_per_batch=0,
            init_row=_row(text, "[INIT]"), last_row=_row(text, f"[iter {k_iters}]"),
            bop_max_err=bop_err, card=repr(card))
        if traj.shape != (k_iters + 1, n, 3, 4) or not np.isfinite(traj).all():
            raise AssertionError(f"refined_poses.npz holds {traj.shape}")
        if launches["raster_sorted"] != expect_sorted or launches["raster_cols"]:
            raise AssertionError(f"an eval render missed the sorted kernel: {launches}")
        if not bop_err <= BOP_ATOL:
            raise AssertionError("bop_results.csv does not read back as the last iterate")

        # Where a batch's time goes once warm: its draw and render
        # (synthetic_batch) and its refinement, each timed alone.
        assets, names, symmetric = load_assets_and_names(cfg, eval_set=True, device=dev)
        model = hl.random_model(4).to(dev).eval()
        k_cam = make_intrinsics(*(getattr(cfg.dataset, f) for f in ("fx", "fy", "cx", "cy")),
                                device=dev)
        batch = next(cli_test.eval_stream(cfg, assets, k_cam, 1, bs))
        kw = dict(num_iters=k_iters, out_size=(cfg.network.input_height, cfg.network.input_width),
                  coarse_iters=cfg.test.coarse_iters)
        draw_ms = ms_per_call(lambda: next(cli_test.eval_stream(cfg, assets, k_cam, 1, bs)), 5)
        refine_ms = ms_per_call(lambda: cli_test.refine_batches(model, assets, [batch], k_cam,
                                                                **kw), 5)
        log("eval_batch", batch=bs, synthetic_batch_ms=draw_ms, refine_ms=refine_ms,
            steady_poses_per_s=bs / (draw_ms + refine_ms) * 1e3,
            cli_batches_ms=(n / _number(r"\(([\d.]+) poses/s", text)) / batches * 1e3)
        del model

        # The evaluator alone on the five iterations' rows, and the ADD-S
        # cross term's memory in both forms on one chunk of 256 rows.
        t0 = time.perf_counter()
        (_, eval_peak) = peak_memory(lambda: [evaluate_poses(assets, names, symmetric, traj[i],
                                                             gt, cls, ks)
                                              for i in range(traj.shape[0])])
        eval_ms = (time.perf_counter() - t0) * 1e3
        rows = slice(0, 256)
        idx = torch.from_numpy(cls[rows]).long().to(dev)
        pts = assets.points.index_select(0, idx)
        est_t, gt_t = (torch.from_numpy(a[rows]).to(dev) for a in (traj[-1], gt))
        new, new_peak = peak_memory(lambda: adds_error(pts, est_t, gt_t, point_block=512))
        old, old_peak = peak_memory(lambda: adds_broadcast(pts, est_t, gt_t, 512))
        log("eval_evaluator", rows=f"{traj.shape[0]}x{n}", points=pts.shape[1],
            chunk=256, point_block=512, ms=eval_ms, peak_mib=eval_peak,
            adds_chunk_peak_mib=new_peak, adds_broadcast_chunk_peak_mib=old_peak,
            adds_forms_max_diff=(new - old).abs().max().item())

        text0, _, _, _ = run_cli(cli_test.main, ["--cfg", path, *dev_arg, "--no-refine",
                                                 "--vis", "2", "--num-samples", str(n)])
        vis = sorted(p.name for p in (out_dir / "vis").iterdir())
        log("eval_no_refine", init_row=_row(text0, "[INIT]"), vis=vis)
        if _row(text0, "[INIT]") != _row(text, "[INIT]") or len(vis) != 2:
            raise AssertionError("--no-refine printed another INIT row, or no montages")

        nh, hyp_n = 4, HYP_SAMPLES
        text_h, sec_h, l_h, peak_h = run_cli(cli_test.main, [
            "--cfg", path, *dev_arg, "--hypotheses", str(nh), "--init-rot-noise", "45",
            "--init-trans-noise", "0.06", "--num-samples", str(hyp_n)])
        counts["eval_hypotheses"] = l_h
        hb = hyp_n // bs
        log("eval_hypotheses", hypotheses=nh, samples=hyp_n,
            refine_poses_per_s=_number(r"\(([\d.]+) poses/s", text_h), seconds=sec_h,
            peak_mib=peak_h, sorted_per_batch=l_h["raster_sorted"] / hb,
            cols_per_batch=l_h["raster_cols"] / hb,
            expected_sorted_per_batch=1 + k_iters + 1,  # + the score render
            init_row=_row(text_h, "[INIT]"), best_row=_row(text_h, "[iter 1]"))
        if l_h["raster_sorted"] != hb * (k_iters + 2) or l_h["raster_cols"]:
            raise AssertionError(f"multi-hypothesis renders missed the sorted kernel: {l_h}")

        for run, overrides, samples in (
                ("eval_occlusion", {}, OCC_SAMPLES),
                ("eval_occlusion_dense",
                 {"objects": ["icosphere_dense", "icosphere_dense2", "torus_dense",
                              "cylinder_dense"]}, OCC_DENSE_SAMPLES)):
            occ_path = experiment_yaml(tmp, "occlusion_small.yaml", **overrides)
            occ_cfg = update_config(occ_path)
            text_o, sec_o, l_o, peak_o = run_cli(cli_test.main, [
                "--cfg", occ_path, *dev_arg, "--num-samples", str(samples)])
            counts[run] = l_o
            ob = samples // occ_cfg.test.batch_size
            faces = max(PROCEDURAL_MESHES[o]().num_faces for o in occ_cfg.dataset.objects)
            log(run, samples=samples, faces=faces,
                size=f"{occ_cfg.dataset.image_height}x{occ_cfg.dataset.image_width}",
                crop=f"{occ_cfg.network.input_height}x{occ_cfg.network.input_width}",
                refine_poses_per_s=_number(r"\(([\d.]+) poses/s", text_o), seconds=sec_o,
                peak_mib=peak_o, sorted_per_batch=l_o["raster_sorted"] / ob,
                cols_per_batch=l_o["raster_cols"] / ob,
                fallback_per_batch=l_o["cols_fallback"] / ob,
                init_row=_row(text_o, "[INIT]"), last_row=_row(text_o, "[iter 4]"))
            dense = faces >= rc._COLS_MIN_FACES_CROP
            # Under 1,024 faces every render is sorted (the scene, the
            # target-only depth, the crops); dense classes take cols.
            if dense and not l_o["raster_cols"] >= ob:
                raise AssertionError(f"dense occlusion renders missed the cols kernel: {l_o}")
            if not dense and (l_o["raster_cols"] or l_o["raster_sorted"] != ob * (2 + k_iters)):
                raise AssertionError(f"occlusion renders missed the sorted kernel: {l_o}")

        # Card against CPU: the evaluator on the same rows.
        assets_cpu, _, _ = load_assets_and_names(cfg, eval_set=True, device="cpu")
        rows = slice(0, EVAL_PARITY_ROWS)
        args = (traj[-1][rows], gt[rows], cls[rows], ks[rows])

        def errors(a):
            i = torch.from_numpy(args[2]).long().to(a.points.device)
            out = compute_pose_errors(
                a.points.index_select(0, i), a.sym_poses.index_select(0, i),
                *(torch.from_numpy(x).to(a.points.device) for x in (args[0], args[1], args[3])),
                point_block=512)
            return {key: v.cpu().numpy() for key, v in out.items()}

        t0 = time.perf_counter()
        e_cpu = errors(assets_cpu)
        cpu_s = time.perf_counter() - t0
        e_card = errors(assets)
        worst = {key: float((np.abs(e_card[key] - e_cpu[key])
                             - EVAL_RTOL * np.abs(e_cpu[key])).max()) for key in e_cpu}
        held = all(worst[key] <= EVAL_ATOL[key] for key in worst)
        res_cpu = evaluate_poses(assets_cpu, names, symmetric, *args)
        res_card = evaluate_poses(assets, names, symmetric, *args)
        near = _near_thresholds(e_cpu, assets_cpu.diameters.numpy(), args[2], symmetric,
                                EvalThresholds())
        table_diff = {
            key: max(abs(res_card["per_class"][c][key] - res_cpu["per_class"][c][key])
                     for c in res_cpu["per_class"])
            for key in ("add(-s)_0.1d", "add_0.1d", "adds_0.1d", "5deg_5cm", "proj2d_5px")}
        log("eval_parity", rows=EVAL_PARITY_ROWS, points=assets.points.shape[1],
            max_excess_over_rtol={k: f"{v:.3g}" for k, v in worst.items()},
            rtol=EVAL_RTOL, atol=EVAL_ATOL, held=held, samples_near_a_threshold=near,
            table_max_diff=table_diff, cpu_s=cpu_s)
        if not held or (near == 0 and any(table_diff.values())):
            raise AssertionError("the evaluator on the card disagrees with the CPU path")

        # Card against CPU: one eval batch made on the CPU through the eval loop.
        model_cpu = hl.random_model(4, dtype=torch.float32)
        model_card = copy.deepcopy(model_cpu).to(dev)
        d = cfg.dataset
        k_cpu = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device="cpu")
        batch = next(cli_test.eval_stream(cfg, assets_cpu, k_cpu, 1, EVAL_PARITY_B))
        kw = dict(num_iters=k_iters, out_size=(cfg.network.input_height, cfg.network.input_width),
                  coarse_iters=cfg.test.coarse_iters)
        t0 = time.perf_counter()
        traj_cpu = cli_test.refine_batches(model_cpu, assets_cpu, [batch], k_cpu, **kw)["traj"]
        cpu_s = time.perf_counter() - t0
        traj_card = cli_test.refine_batches(model_card, assets, [batch], k_cpu, **kw)["traj"]
        diff = (traj_card.cpu() - traj_cpu).abs().max().item()
        moved = (traj_cpu[-1] - traj_cpu[0]).abs().max().item()
        log("eval_parity", case="eval_loop", batch=EVAL_PARITY_B, dtype="float32",
            max_pose_diff=diff, atol=EVAL_TRAJ_ATOL, moved=moved, cpu_s=cpu_s)
        if not diff <= EVAL_TRAJ_ATOL or not moved > 1e-3:
            raise AssertionError("the eval loop on the card disagrees with the CPU path")


def phase_tracking(dev, card, rc, counts):
    """The video toolkit and tracking at full width: ``cli.track.main`` at
    the flagship dataset (480x640, the four classes, one object a sequence
    so 4 sequences, TRACK_FRAMES frames, windows of TRACK_WINDOW: one
    boundary crossed), from the seed-7 random model: gen_video's ms a frame
    (render, PNG write), frames/s and launches a sequence; the identical
    call again (the manifest matches: no generation); --num-frames 6 (it
    does not); recovery armed over 2 occluders; then ``_render_frame`` of
    one 2-object frame card against CPU."""
    import tempfile

    import numpy as np

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli import track as cli_track
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.data.video import _render_frame
    from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES
    from deepim_tpu_torch.raster.raster_ref import Lighting
    from deepim_tpu_torch.refine import build_assets, gather_class, render_crops
    from deepim_tpu_torch.train import checkpoint_dir, save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = experiment_yaml(tmp, "synthetic_all_c2f.yaml")
        cfg = update_config(path)
        save_checkpoint(checkpoint_dir(cfg), hl.SEED, hl.random_model(4).state_dict())
        base = ["--cfg", path, "--device", str(dev), "--num-frames", str(TRACK_FRAMES),
                "--window", str(TRACK_WINDOW)]
        seqs = len(cfg.dataset.objects)
        text1, sec1, l1, _ = run_cli(cli_track.main, base)
        text2, sec2, l2, peak2 = run_cli(cli_track.main, base)
        counts["track"] = l2
        gen = {k: l1[k] - l2[k] for k in l1}
        counts["gen_video"] = gen
        per_seq = 4 + (TRACK_FRAMES - 1) * 2  # --iters-first 4 on frame 0, 2 on the others
        frames = seqs * TRACK_FRAMES
        log("track", sequences=seqs, frames=TRACK_FRAMES, window=TRACK_WINDOW,
            size=f"{cfg.dataset.image_height}x{cfg.dataset.image_width}",
            gen_render_ms_per_frame=_number(r"render ([\d.]+) ms a frame", text1),
            gen_png_write_ms_per_frame=_number(r"PNG write ([\d.]+) ms a frame", text1),
            gen_seconds=sec1 - sec2, gen_sorted_per_frame=gen["raster_sorted"] / frames,
            gen_cols_per_frame=gen["raster_cols"] / frames,
            frames_per_s=_number(r"\(([\d.]+) frames/s", text2), seconds=sec2,
            load_s=_number(r"loading ([\d.]+)s", text2),
            refine_s=_number(r"refining ([\d.]+)s", text2), peak_mib=peak2,
            sorted_per_sequence=l2["raster_sorted"] / seqs,
            cols_per_sequence=l2["raster_cols"] / seqs, expected_sorted_per_sequence=per_seq,
            mean_row=_row(text2, "MEAN"), card=repr(card))
        if "generating" not in text1 or "generating" in text2 or "reusing" not in text2:
            raise AssertionError("the second identical call did not reuse the generated data")
        if l2["raster_sorted"] != seqs * per_seq or l2["raster_cols"]:
            raise AssertionError(f"a tracking render missed the sorted kernel: {l2}")
        if gen["raster_sorted"] != 2 * frames or gen["raster_cols"]:
            raise AssertionError(f"gen_video rendered off its two sorted renders a frame: {gen}")

        text3, _, _, _ = run_cli(cli_track.main, base[:4] + ["--num-frames", "6"] + base[6:])
        dirs = sorted(p.name for p in (Path(tmp) / cfg.experiment).iterdir()
                      if p.name.startswith("video_data_"))
        log("track_manifest", reused_identical=True, regenerated_at_6_frames="generating" in text3,
            data_dirs=dirs)
        if "generating" not in text3 or len(dirs) != 2:
            raise AssertionError("--num-frames 6 reused data generated for 8 frames")

        text4, sec4, l4, peak4 = run_cli(
            cli_track.main, base + ["--occluders", "2", "--recover-threshold", "-0.12"])
        counts["track_armed"] = l4
        low = [ln for ln in text4.splitlines() if "low-confidence" in ln]
        log("track_armed", occluders=2, recover_threshold=-0.12,
            gen_render_ms_per_frame=_number(r"render ([\d.]+) ms a frame", text4),
            gen_png_write_ms_per_frame=_number(r"PNG write ([\d.]+) ms a frame", text4),
            frames_per_s=_number(r"\(([\d.]+) frames/s", text4), seconds=sec4, peak_mib=peak4,
            launches=l4, low_confidence_windows=len(low), mean_row=_row(text4, "MEAN"))

    # Card against CPU: one 2-object frame at 480x640.
    names = list(cfg.dataset.objects)
    meshes = [PROCEDURAL_MESHES[n]() for n in names]
    image = (cfg.dataset.image_height, cfg.dataset.image_width)
    k_np = np.array([[cfg.dataset.fx, 0, cfg.dataset.cx], [0, cfg.dataset.fy, cfg.dataset.cy],
                     [0, 0, 1]], np.float32)
    rng = np.random.RandomState(11)
    poses = np.zeros((2, 3, 4), np.float32)
    for i, tz in enumerate((0.62, 0.7)):
        q = rng.randn(4)
        poses[i] = np.concatenate([_quat_mat(q / np.linalg.norm(q)),
                                   [[0.03 * (2 * i - 1)], [0.01], [tz]]], 1)
    cls = torch.tensor([1, 3])  # icosphere, torus
    light = Lighting(0.6, 0.5, (0.2, -0.3, -1.0))
    outs = {}
    for where in ("cpu", dev):
        a = build_assets(meshes, num_points=256, device=where)
        args = (cls.to(where), torch.from_numpy(poses).to(where), torch.from_numpy(k_np).to(where))
        outs[str(where)] = [t.cpu() for t in _render_frame(a, *args, image, light)]
        if where == "cpu":
            deps = render_crops(gather_class(a, args[0]), args[1],
                                args[2].expand(2, 3, 3).contiguous(), image)[1]
    (rgb_c, d_c, lab_c), (rgb_k, d_k, lab_k) = outs["cpu"], outs[str(dev)]
    rgb_off, dep_off, err = mismatch((rgb_k, d_k), (rgb_c, d_c))
    both = (deps > 0).all(0)
    ties = both & ((deps[0] - deps[1]).abs() < LABEL_TIE_M)
    label_off = ((lab_k != lab_c) & ~ties).sum().item()
    log("track_parity", case="render_frame", size=f"{image[0]}x{image[1]}", objects=2,
        rgb_mismatch=rgb_off, depth_mismatch=dep_off, max_abs_err=err,
        label_pixels=int((lab_c > 0).sum()), overlap_pixels=int(both.sum()),
        tie_pixels=int(ties.sum()), labels_off_ties=label_off,
        labels_differing=int((lab_k != lab_c).sum()))
    if rgb_off > RASTER_FRAC or dep_off > RASTER_FRAC or label_off or not both.any():
        raise AssertionError("_render_frame on the card disagrees with the CPU path")


DISK_SIZE = (480, 640)  # lm6d_all: frames and network input
DISK_FRAMES = 64  # generated frames an object (the test split: 19 each, padded to 80)
DISK_DENSE_FRAMES = 8  # frames an object of the 20,480-face OBJ root
DISK_TRAIN_STEPS = 20
DISK_KEYFRAME_FRAMES = 8  # gen_video frames of the YCB-style sequence (every other a keyframe)
DISK_PARITY_B = 4  # rows of one on-disk batch refined on card and CPU
DISK_LOOP_PASSES = 2  # passes of the test split in the loader and loop timings (4 until
# the script passed ~1,000 s)
DECODE_REPS = 5


def encode_filtered(image, kind) -> bytes:
    """PNG bytes of ``image`` (uint8 RGB or uint16 grey) with every row
    filtered by ``kind``: 0, 4 (Paeth) or "sub_up" (Sub and Up rows in
    turn); vectorised, since a filter predicts from the unfiltered bytes."""
    import struct
    import zlib

    import numpy as np

    from deepim_tpu_torch.data import png

    if image.dtype == np.uint16:
        rows, colour, depth, bpp = image.astype(">u2").view(np.uint8), 0, 16, 2
    else:
        rows, colour, depth, bpp = image, 2, 8, 3
    h, w = image.shape[:2]
    cur = rows.reshape(h, -1).astype(np.int16)
    left = np.pad(cur, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(cur, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    if kind == 0:
        pred, kinds = np.zeros_like(cur), np.zeros(h, np.uint8)
    elif kind == 4:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        kinds = np.full(h, 4, np.uint8)
    else:
        kinds = np.where(np.arange(h) % 2 == 0, 1, 2).astype(np.uint8)
        pred = np.where((kinds == 1)[:, None], left, up)
    raw = np.concatenate([kinds[:, None], ((cur - pred) % 256).astype(np.uint8)], 1)
    return (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes())) + png._chunk(b"IEND", b""))


def write_textured_obj(path: Path, mesh, name: str) -> None:
    """``mesh`` (with uv and texture) as ``path`` + an MTL and a PNG map."""
    import numpy as np

    from deepim_tpu_torch.data.png import write_png

    write_png(str(path.parent / f"{name}.png"), np.round(mesh.texture * 255).astype(np.uint8))
    (path.parent / f"{name}.mtl").write_text(f"newmtl m\nKd 0.7 0.7 0.7\nmap_Kd {name}.png\n")
    lines = [f"mtllib {name}.mtl", "usemtl m"]
    lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in mesh.vertices.tolist()]
    lines += [f"vt {u!r} {v!r}" for u, v in mesh.uv.tolist()]
    lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in (mesh.faces + 1).tolist()]
    path.write_text("\n".join(lines) + "\n")


def disk_yaml(tmp: str, cfg_file: str, train=None, **dataset) -> str:
    """:func:`experiment_yaml` with ``train`` fields overridden too."""
    import yaml

    path = experiment_yaml(tmp, cfg_file, **dataset)
    if train:
        spec = yaml.safe_load(Path(path).read_text())
        spec["train"].update(train)
        Path(path).write_text(yaml.safe_dump(spec))
    return path


def table_rows(text: str) -> list[str]:
    """The per-iteration lines and the table of a cli.test run."""
    keep = ("[INIT]", "[iter", "MEAN")
    return [ln for ln in text.splitlines()
            if ln.startswith(keep) or (ln[:1].isalpha() and "±" in ln)]


def phase_disk(dev, card, rc, counts, work: str) -> dict:
    """The on-disk datasets at full width (experiments/cfgs/lm6d_all.yaml:
    480x640 frames and network input, bf16, K=4, test.init posecnn, four
    classes of at most 576 faces): generate an LM6d root on the card
    (gen_procedural_dataset, DISK_FRAMES an object; gen_rendered on its
    train split); the decoder plain against C++ on its frames written with
    filter 0, Sub/Up and Paeth rows; a copy of the root whose test PNGs are
    Paeth rows; cli.test on both roots (equal tables), the loader alone,
    the refinement alone, the device's idle share over the streamed loop,
    --init-poses from a BOP CSV, one batch card against CPU and the card's
    uint8/uint16 conversion against the host's; a root of 20,480-face OBJ
    models with MTL and texture, decimated to 4,096 on load (the cols
    kernel); DISK_TRAIN_STEPS of cli.train on disk at syn_fraction 0.5;
    the YCB-Video keyframe protocol with --posecnn-mat.  Its roots stay in
    ``work``; returns what phase 18 reads of them: the filter-0 root, its
    objects and test records, one frame's samples and the streamed loop's
    idle share."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from scipy.io import savemat

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.cli import train as cli_train
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.data import lm6d, png, toolkit
    from deepim_tpu_torch.data import video as video_data
    from deepim_tpu_torch.eval import write_bop_csv
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES, texturize
    from deepim_tpu_torch.train import checkpoint_dir, save_checkpoint
    from deepim_tpu_torch.train import train as train_mod

    with contextlib.nullcontext(work) as tmp:
        root_a, root_b = f"{tmp}/lm6d", f"{tmp}/lm6d_paeth"
        path = disk_yaml(tmp, "lm6d_all.yaml", root=root_a)
        cfg = update_config(path)
        d = cfg.dataset
        objects, size = list(d.objects), (d.image_height, d.image_width)
        k_np = np.array([[d.fx, 0, d.cx], [0, d.fy, d.cy], [0, 0, 1]], np.float32)

        # 1. Generate the root on the card.
        def generate(_):
            toolkit.gen_procedural_dataset(root_a, objects, k_np, size,
                                           frames_per_obj=DISK_FRAMES, device=dev)

        text, gen_s, gen_launches, _ = run_cli(generate, [])
        meshes = {o: PROCEDURAL_MESHES[o]() for o in objects}
        ds = lm6d.LM6DDataset(root_a, objects)
        t0 = time.perf_counter()
        n_rendered = toolkit.gen_rendered(ds, meshes, k_np, size, device=dev)
        ren_s = time.perf_counter() - t0
        frames = len(objects) * DISK_FRAMES
        log("disk_gen", objects=len(objects), frames=frames, size=f"{size[0]}x{size[1]}",
            frames_per_s=frames / gen_s, seconds=gen_s,
            render_ms_per_frame=_number(r"render ([\d.]+) ms a frame", text),
            png_write_ms_per_frame=_number(r"PNG write ([\d.]+) ms a frame", text),
            png_write_share=_number(r"PNG write ([\d.]+) ms a frame", text) * frames
            / 1e3 / gen_s, launches=gen_launches, rendered_views=n_rendered,
            rendered_per_s=n_rendered / ren_s, card=repr(card))
        if gen_launches["raster_sorted"] != len(objects) or gen_launches["raster_cols"]:
            raise AssertionError(f"gen_observed missed one sorted render an object: "
                                 f"{gen_launches}")
        recs = [r for o in objects for r in ds.gt_roidb(o, "test")]
        if len(recs) % cfg.test.batch_size == 0:
            raise AssertionError("the generated test split needs no padding")

        # 2. The decoder, plain against C++, and the Paeth copy of the root.
        shutil.copytree(root_a, root_b)
        sample = ds.load_frame_raw(recs[0])
        timings = {}
        for image_kind, image in (("rgb", sample[0]), ("depth16", sample[1])):
            for kind in (0, "sub_up", 4):
                data = encode_filtered(image, kind)
                fast = png.decode_png(data)
                t0 = time.perf_counter()
                plain = png.decode_png(data, plain=True)
                plain_ms = (time.perf_counter() - t0) * 1e3
                ms = []
                for _ in range(DECODE_REPS):
                    t0 = time.perf_counter()
                    png.decode_png(data)
                    ms.append((time.perf_counter() - t0) * 1e3)
                if not (np.array_equal(fast, image) and np.array_equal(plain, image)):
                    raise AssertionError(f"decode of {image_kind} filter {kind} differs")
                timings[f"{image_kind}_{kind}"] = (statistics.median(ms), plain_ms)
        for (image_kind, kind), (ms, plain_ms) in zip(
                [(a, b) for a in ("rgb", "depth16") for b in (0, "sub_up", 4)], timings.values()):
            log("disk_decode", image=image_kind, filter=kind, size=f"{size[0]}x{size[1]}",
                cpp_ms=ms, plain_ms=plain_ms, speedup=plain_ms / ms, equal=True, card=repr(card))

        def paeth(path):
            Path(path).write_bytes(encode_filtered(png.read_png(path), 4))

        ds_b = lm6d.LM6DDataset(root_b, objects)
        paths = [ds_b._obs(r.scene, r.frame, s) for r in recs for s in ("color.png", "depth.png")]
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(paeth, paths))
        filters = {png_filters(Path(p).read_bytes()) for p in paths[:2]}
        if filters != {(4,)}:
            raise AssertionError(f"the Paeth root's PNGs have row filters {filters}")

        # 3. cli.test on both roots, with --save-poses.
        save_checkpoint(checkpoint_dir(cfg), hl.SEED, hl.random_model(len(objects)).state_dict())
        bs, k_iters = cfg.test.batch_size, cfg.test.test_iter
        n_pad = (len(recs) + bs - 1) // bs * bs
        batches = n_pad // bs
        outs = {}
        for tag, root in (("warm", root_a), ("filter0", root_a), ("paeth", root_b)):
            p = disk_yaml(tmp, "lm6d_all.yaml", root=root)
            text, seconds, launches, peak = run_cli(
                cli_test.main, ["--cfg", p, "--device", str(dev), "--save-poses"])
            npz = np.load(Path(tmp) / cfg.experiment / "refined_poses.npz")
            outs[tag] = (text, seconds, launches, peak, npz["traj"],
                         (Path(tmp) / cfg.experiment / "bop_results.csv").read_text())
        counts["disk_test"] = outs["paeth"][2]
        for tag in ("filter0", "paeth"):
            text, seconds, launches, peak, traj, _ = outs[tag]
            log("disk_test", root=tag, records=len(recs), padded_to=n_pad, batch=bs,
                iters=k_iters, dtype=cfg.network.dtype, seconds=seconds,
                poses_per_s=_number(r"\(([\d.]+) poses/s", text), peak_mib=peak,
                sorted_per_batch=launches["raster_sorted"] / batches,
                cols_per_batch=launches["raster_cols"] / batches,
                predicted_sorted_per_batch=k_iters, predicted_cols_per_batch=0,
                last_row=_row(text, f"[iter {k_iters}]"), mean_row=_row(text, "MEAN"),
                card=repr(card))
            if launches["raster_sorted"] != batches * k_iters or launches["raster_cols"]:
                raise AssertionError(f"an on-disk refine render missed the sorted kernel: "
                                     f"{launches}")
            if traj.shape != (k_iters + 1, len(recs), 3, 4) or not np.isfinite(traj).all():
                raise AssertionError(f"refined_poses.npz holds {traj.shape}")
        print("\n".join(table_rows(outs["paeth"][0])), flush=True)
        traj_diff = float(np.abs(outs["paeth"][4] - outs["filter0"][4]).max())
        same_table = table_rows(outs["paeth"][0]) == table_rows(outs["filter0"][0])
        bop_ids = [ln.split(",")[:3] for ln in outs["paeth"][5].splitlines()[1:]]
        want_ids = [[str(int(r.scene)), str(int(r.frame)), str(r.class_idx + 1)] for r in recs]
        log("disk_test_roots", tables_equal=same_table, traj_max_diff=traj_diff,
            bop_rows=len(bop_ids), bop_ids_real=bop_ids == want_ids)
        if not same_table or bop_ids != want_ids:
            raise AssertionError("the filter-0 and Paeth roots gave other tables or BOP ids")

        # --init-poses from a BOP CSV of the roots' init poses.
        csv = f"{tmp}/init.csv"
        write_bop_csv(csv, np.stack([r.init_pose for r in recs]),
                      np.array([r.class_idx + 1 for r in recs]),
                      scene_ids=np.array([int(r.scene) for r in recs]),
                      im_ids=np.array([int(r.frame) for r in recs]))
        shutil.rmtree(f"{root_b}/init_poses")  # without --init-poses they would be GT
        text, _, _, _ = run_cli(cli_test.main, ["--cfg", p, "--device", str(dev),
                                                "--init-poses", csv])
        matched = int(_number(r"matched (\d+)/", text))
        log("disk_init_poses", matched=matched, records=len(recs),
            init_row_equal=_row(text, "[INIT]") == _row(outs["paeth"][0], "[INIT]"))
        if matched != len(recs) or _row(text, "[INIT]") != _row(outs["paeth"][0], "[INIT]"):
            raise AssertionError("--init-poses did not reproduce the roots' init poses")

        # The loader alone, the refinement alone and the streamed loop (what
        # cli.test runs), over DISK_LOOP_PASSES passes of the test split.
        p = disk_yaml(tmp, "lm6d_all.yaml", root=root_b)
        cfg_b = update_config(p)
        assets, _, _ = load_assets_and_names(cfg_b, eval_set=True, device=dev)
        model = hl.random_model(len(objects)).to(dev).eval()
        k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
        args = cli_test.parse_args(["--cfg", p])
        pin = dev.type == "cuda"
        loop = recs * DISK_LOOP_PASSES
        loop_n = -(-len(loop) // bs) * bs
        padded = loop + loop[-1:] * (loop_n - len(loop))
        extra = {"pose_src": np.stack([r.pose for r in padded]),
                 "pose_tgt": np.stack([r.pose for r in padded]),
                 "class_idx": np.array([r.class_idx for r in padded], np.int64)}

        def stream(dsx, pin_memory, keep=()):
            for b in lm6d.prefetch_iter(lm6d.iter_frame_batches(
                    dsx, loop, bs, pad_to=loop_n, pin_memory=pin_memory, extra=extra)):
                yield {k: v for k, v in b.items() if k not in ("obs_depth", "obs_mask")
                       or k in keep}  # lm6d_all's network takes neither

        loop_batches = loop_n // bs
        loader_ms = {}
        for tag, dsx in (("filter0", ds), ("paeth", ds_b)):
            list(lm6d.iter_frame_batches(dsx, recs[:bs], bs, pin_memory=pin))  # warm
            t0 = time.perf_counter()
            for _ in stream(dsx, pin):
                pass
            loader_ms[tag] = (time.perf_counter() - t0) * 1e3 / loop_batches
        host = list(stream(ds_b, False, keep=("obs_depth", "obs_mask")))
        as_tested = [{k: v for k, v in b.items() if k not in ("obs_depth", "obs_mask")}
                     for b in host]
        kw = dict(num_iters=k_iters, out_size=(cfg.network.input_height, cfg.network.input_width))
        refine_ms = ms_per_call(lambda: cli_test.refine_batches(model, assets, as_tested, k_cam,
                                                                **kw), 2) / loop_batches
        busy_ms, wall_ms = device_busy(lambda: cli_test.refine_batches(
            model, assets, stream(ds_b, pin), k_cam, **kw))
        stack_ms = batch_host_float_ms(host[0])
        pinned = {k: host[0][k].pin_memory() if pin else host[0][k]
                  for k in ("obs_rgb", "obs_depth")}
        conv_ms = ms_per_call(lambda: lm6d.to_device(pinned, dev), 5)
        streamed = wall_ms / loop_batches
        idle_share = 1 - busy_ms / wall_ms
        log("disk_loop", batch=bs, batches=loop_batches, passes=DISK_LOOP_PASSES,
            decode_threads=4, loader_ms_per_batch_filter0=loader_ms["filter0"],
            loader_ms_per_batch_paeth=loader_ms["paeth"], refine_ms_per_batch=refine_ms,
            streamed_ms_per_batch=streamed, device_busy_ms=busy_ms, wall_ms=wall_ms,
            idle_share=idle_share, decode="native.decode_png, one C++ call a PNG",
            loader_hidden_share=min(1.0, max(0.0, (loader_ms["paeth"] + refine_ms - streamed)
                                             / loader_ms["paeth"])),
            host_float_convert_ms_per_batch=stack_ms, card_copy_convert_ms_per_batch=conv_ms,
            bytes_per_batch_u8=sum(host[0][k].numel() * host[0][k].element_size()
                                   for k in ("obs_rgb", "obs_depth")),
            card=repr(card))

        # The card's conversion against the host's, every uint8 and uint16 value.
        u8 = torch.arange(256, dtype=torch.uint8)
        u16 = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16))
        got = lm6d.to_device({"obs_rgb": u8, "obs_depth": u16}, dev)
        want_rgb = np.arange(256, dtype=np.uint8).astype(np.float32) / 255.0
        want_dep = np.arange(65536, dtype=np.uint16).astype(np.float32) / lm6d.DEPTH_FACTOR
        batch_eq = all(torch.equal(lm6d.to_device(host[0], dev)[k].cpu(),
                                   lm6d.to_device(host[0], "cpu")[k])
                       for k in ("obs_rgb", "obs_depth"))
        conv_ok = (np.array_equal(got["obs_rgb"].cpu().numpy(), want_rgb)
                   and np.array_equal(got["obs_depth"].cpu().numpy(), want_dep) and batch_eq)
        log("disk_convert", uint8_values=256, uint16_values=65536, bit_equal=conv_ok)
        if not conv_ok:
            raise AssertionError("the card's uint8/uint16 conversion differs from the host's")

        # One CPU-made batch, card against CPU (float32).
        part = {k: (v[:DISK_PARITY_B].clone() if isinstance(v, torch.Tensor) else None)
                for k, v in as_tested[0].items()}
        trajs = []
        for where in (dev, torch.device("cpu")):
            a = load_assets_and_names(cfg_b, eval_set=True, device=where)[0]
            m = hl.random_model(len(objects), dtype=torch.float32).to(where).eval()
            t0 = time.perf_counter()
            trajs.append(cli_test.refine_batches(m, a, [part], k_cam.to(where),
                                                 **kw)["traj"].cpu())
            cpu_s = time.perf_counter() - t0
        diff = (trajs[0] - trajs[1]).abs().max().item()
        moved = (trajs[1][-1] - trajs[1][0]).abs().max().item()
        log("disk_parity", batch=DISK_PARITY_B, dtype="float32", max_pose_diff=diff,
            atol=EVAL_TRAJ_ATOL, moved=moved, cpu_s=cpu_s)
        if not diff <= EVAL_TRAJ_ATOL or not moved > 1e-3:
            raise AssertionError("an on-disk batch refines differently on card and CPU")
        del host, as_tested, part

        # 4. 20,480-face OBJ models with MTL and texture, decimated on load.
        dense = ["icosphere_dense", "icosphere_dense2"]
        root_d = f"{tmp}/lm6d_dense"
        rc.reset_launches()
        toolkit.gen_observed(root_d, {o: PROCEDURAL_MESHES[o]() for o in dense}, k_np, size,
                             frames_per_obj=DISK_DENSE_FRAMES, device=dev)
        dense_gen = dict(rc.LAUNCHES)
        for i, o in enumerate(dense):
            mdir = Path(root_d) / "models" / o
            (mdir / "textured.ply").unlink()
            write_textured_obj(mdir / "textured.obj", texturize(PROCEDURAL_MESHES[o](), 70 + i),
                               "textured")
        p = disk_yaml(tmp, "lm6d_all.yaml", root=root_d, objects=dense)
        cfg_d = update_config(p)
        save_checkpoint(checkpoint_dir(cfg_d), hl.SEED, hl.random_model(len(dense)).state_dict())
        t0 = time.perf_counter()
        a_dense = load_assets_and_names(cfg_d, eval_set=True, device="cpu")[0]
        load_s = time.perf_counter() - t0
        text, seconds, launches, _ = run_cli(cli_test.main, ["--cfg", p, "--device", str(dev)])
        n_dense = sum(len(lm6d.LM6DDataset(root_d, dense).gt_roidb(o, "test")) for o in dense)
        dense_batches = (n_dense + bs - 1) // bs
        counts["disk_test_dense"] = launches
        log("disk_dense", models="20,480-face textured OBJ", max_faces=cfg_d.dataset.max_faces,
            faces_after_load=a_dense.tri_pos.shape[2], textured=a_dense.textured,
            load_s=load_s, records=n_dense, batches=dense_batches, seconds=seconds,
            cols_per_batch=launches["raster_cols"] / dense_batches,
            sorted_per_batch=launches["raster_sorted"] / dense_batches, gen_launches=dense_gen,
            mean_row=_row(text, "MEAN"))
        if launches["raster_cols"] < dense_batches or not a_dense.textured:
            raise AssertionError(f"the dense OBJ run missed the cols kernel: {launches}")

        # 5. cli.train on disk, syn_fraction 0.5.
        p = disk_yaml(tmp, "lm6d_all.yaml", root=root_a,
                      train={"num_steps": DISK_TRAIN_STEPS, "log_every": 1, "warmup_steps": 0,
                             "checkpoint_every": 10 ** 6, "syn_fraction": 0.5})
        cfg_t = update_config(p)
        step_ms = {"disk": [], "synthetic": []}
        batcher = []

        def timed(kind, make):
            def wrapped(*a, **kw):
                fn = make(*a, **kw)
                if kind == "disk":
                    batcher.append(fn.batcher)

                def step(state, g):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(state, g)
                    torch.cuda.synchronize()
                    step_ms[kind].append((time.perf_counter() - t0) * 1e3)
                    return out
                step.batcher = getattr(fn, "batcher", None)
                return step
            return wrapped

        make_disk, make_syn = cli_train.make_disk_step, train_mod.make_synthetic_train_step
        cli_train.make_disk_step = timed("disk", make_disk)
        train_mod.make_synthetic_train_step = timed("synthetic", make_syn)
        try:
            text, seconds, launches, peak = run_cli(cli_train.main,
                                                    ["--cfg", p, "--device", str(dev)])
        finally:
            cli_train.make_disk_step, train_mod.make_synthetic_train_step = make_disk, make_syn
        counts["disk_train"] = launches
        losses = [float(x) for x in __import__("re").findall(r"loss=([\d.eE+-]+)", text)]
        n_disk = len(step_ms["disk"])
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log("disk_train", steps=DISK_TRAIN_STEPS, batch=cfg_t.train.batch_size,
            disk_steps=n_disk, synthetic_steps=len(step_ms["synthetic"]),
            disk_step_ms=statistics.median(step_ms["disk"][1:]),
            synthetic_step_ms=statistics.median(step_ms["synthetic"][1:]),
            loader_wait_ms_per_disk_step=batcher[0].wait_s * 1e3 / max(n_disk, 1),
            loss_first5=first, loss_last5=last, seconds=seconds, peak_mib=peak,
            launches=launches, card=repr(card))
        if (n_disk != DISK_TRAIN_STEPS // 2 or len(losses) != DISK_TRAIN_STEPS
                or not all(math.isfinite(x) for x in losses) or not last < first):
            raise AssertionError(f"on-disk training: {n_disk} disk steps, losses {losses}")

        # 6. The YCB-Video keyframe protocol with PoseCNN .mat inits.
        root_v = f"{tmp}/ycbv"
        vds = video_data.gen_video(root_v, meshes, k_np, size, num_frames=DISK_KEYFRAME_FRAMES,
                                   device=dev)
        seq = vds.sequences()[0]
        vds.write_keyframes([(seq, f) for f in vds.frame_ids(seq)[::2]])
        kf_recs = video_data.keyframe_records(vds)
        os.makedirs(f"{tmp}/posecnn")
        rng = np.random.RandomState(5)
        for ki, (s, f) in enumerate(vds.keyframes()):
            rois, poses = [], []
            for o in vds.objects_in(s):
                gt = vds.keyframe_pose(s, f, o)
                q = _mat_quat(gt[:, :3]) + rng.normal(0, 0.02, 4)
                rois.append([0, objects.index(o) + 1, 0, 0, 0, 0, 0.9])
                poses.append(np.concatenate([q, gt[:, 3] + rng.normal(0, 0.01, 3)]))
            savemat(f"{tmp}/posecnn/{ki:06d}.mat", {"rois": np.asarray(rois, np.float32),
                                                   "poses": np.asarray(poses, np.float32)})
        p = disk_yaml(tmp, "lm6d_all.yaml", name="ycb_video", root=root_v,
                      obj_ids=list(range(1, len(objects) + 1)))
        save_checkpoint(checkpoint_dir(update_config(p)), hl.SEED,
                        hl.random_model(len(objects)).state_dict())
        decodes = []
        load = video_data.VideoDataset.load_frame_samples

        def counted(self, s, f):
            decodes.append((s, f))
            return load(self, s, f)

        video_data.VideoDataset.load_frame_samples = counted
        try:
            text, seconds, launches, _ = run_cli(cli_test.main, [
                "--cfg", p, "--device", str(dev), "--posecnn-mat", f"{tmp}/posecnn"])
        finally:
            video_data.VideoDataset.load_frame_samples = load
        counts["disk_ycb_keyframes"] = launches
        matched = int(_number(r"matched (\d+)/", text))
        padded = kf_recs + kf_recs[-1:] * (-len(kf_recs) % bs)
        want_decodes = sum(len({(r.scene, r.frame) for r in padded[i:i + bs]})
                           for i in range(0, len(padded), bs))  # once a keyframe a batch
        log("disk_keyframes", keyframes=len(vds.keyframes()), records=len(kf_recs),
            matched=matched, decodes=len(decodes), expected_decodes=want_decodes,
            decodes_per_keyframe=len(decodes)
            / len(vds.keyframes()), seconds=seconds,
            poses_per_s=_number(r"\(([\d.]+) poses/s", text),
            sorted_per_batch=launches["raster_sorted"] / -(-len(kf_recs) // bs),
            mean_row=_row(text, "MEAN"), card=repr(card))
        if matched != len(kf_recs) or len(decodes) != want_decodes:
            raise AssertionError(f"keyframe protocol: matched {matched}/{len(kf_recs)}, "
                                 f"{len(decodes)} decodes of {len(vds.keyframes())} keyframes")
    return {"root": root_a, "objects": objects, "records": recs, "sample": sample,
            "idle_share": idle_share, "streamed_ms_per_batch": streamed}


RELEASE_FRAMES = 8  # generated frames an object, re-laid out as each release (16 until phase 19)
RELEASE_DENSE_FRAMES = 4  # frames an object of the 20,480-face BOP release
RELEASE_PARITY_B = 4  # rows of one converted-root batch refined on card and CPU
RELEASE_JPEG_RESTART = 8  # MCUs a restart interval of the decoder's test frames
RELEASE_METRES_ERRORS = {"bop-t-meters"}  # what the validator names on a BOP drop in metres


def release_yaml(tmp: str, tag: str, **network) -> str:
    """experiments/cfgs/lm6d_all.yaml with output_dir ``tmp/tag`` (and the
    network fields of ``network``): the runbook's --cfg -> its path."""
    import yaml

    spec = yaml.safe_load((ROOT / "experiments" / "cfgs" / "lm6d_all.yaml").read_text())
    spec["output_dir"] = f"{tmp}/{tag}"
    spec.setdefault("network", {}).update(network)
    path = Path(tmp) / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(spec))
    return str(path)


@contextlib.contextmanager
def timed_calls(module, names, seconds: dict):
    """``module.<name>`` of each name wrapped to append each call's wall
    seconds to ``seconds[name]`` (callers look the name up at call time)."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds.setdefault(n, []).append(time.perf_counter() - t0)
        return timed

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield seconds
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def phase_releases(dev, card, rc, counts):
    """Public releases at full width (experiments/cfgs/lm6d_all.yaml: 480x640
    frames and network input, test B=16, K=4, bf16): a root generated on the
    card (RELEASE_FRAMES an object, the classes in name order, as the
    runbook's config lists them) re-laid out by
    tests/test_torch_release_fixtures.py as a BOP JSON release, a SIXD YAML
    one, an original LINEMOD one (baseline JPEG frames, .dpt, .rot, .tra in
    cm, mm mesh) and an original YCB-Video one (-meta.mat, global ids,
    factor_depth 10000); the JPEG decoder C++ against plain; each release
    through cli.runbook (detect, convert, validate, cli.test on the card)
    and its converted root against the generated one; a copy of the BOP
    release in metres stops with exit code 2; a BOP release of 20,480-face
    meshes (the cols kernel); the seed-7 model exported as MXNet weights
    through --weights, its table and trajectories against the same model
    loaded directly, and card against CPU with mxnet_pad: the network on
    one input and one converted-root batch refined from perturbed inits
    (within 1e-5), the same batch from its GT poses printed (a pixel that
    one side's pose puts across a face edge moves the next update by more:
    PERF.md §6, PR 10)."""
    import io
    import re
    import shutil
    import tempfile

    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_release_fixtures as fx

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli import runbook
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.config import save_config, update_config
    from deepim_tpu_torch.data import bop, jpeg, lm6d, lm_original, png, toolkit, validate
    from deepim_tpu_torch.data import video as video_data
    from deepim_tpu_torch.data.pairs import perturb_poses
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES
    from deepim_tpu_torch.train import checkpoint as ckpt
    from deepim_tpu_torch.train.convert_mxnet import export_mxnet_npz
    from deepim_tpu_torch.train.train import make_model

    with tempfile.TemporaryDirectory() as tmp:
        cfg = update_config(release_yaml(tmp, "base"))
        d = cfg.dataset
        objects = sorted(d.objects)
        size = (d.image_height, d.image_width)
        k_np = np.array([[d.fx, 0, d.cx], [0, d.fy, d.cy], [0, 0, 1]], np.float32)
        bs, k_iters = cfg.test.batch_size, cfg.test.test_iter
        spec = ",".join(f"{i + 1}:{o}" for i, o in enumerate(objects))
        model = hl.random_model(len(objects))

        # 1. The root, generated on the card.
        gen = f"{tmp}/gen"
        rc.reset_launches()
        t0 = time.perf_counter()
        toolkit.gen_procedural_dataset(gen, objects, k_np, size, frames_per_obj=RELEASE_FRAMES,
                                       device=dev)
        frames = len(objects) * RELEASE_FRAMES
        log("release_gen", objects=len(objects), frames=frames, size=f"{size[0]}x{size[1]}",
            seconds=time.perf_counter() - t0, launches=dict(rc.LAUNCHES))

        # 2. The JPEG decoder, C++ against plain, on a generated frame.
        sample = png.read_png(f"{gen}/data/observed/00/000000-color.png")
        for sub in ("4:2:0", "4:4:4"):
            data = fx.encode_jpeg(sample, 90, sub, RELEASE_JPEG_RESTART)
            fast = jpeg.decode_jpeg(data)
            t0 = time.perf_counter()
            plain = jpeg.decode_jpeg(data, plain=True)
            plain_ms = (time.perf_counter() - t0) * 1e3
            ms = []
            for _ in range(DECODE_REPS):
                t0 = time.perf_counter()
                jpeg.decode_jpeg(data)
                ms.append((time.perf_counter() - t0) * 1e3)
            equal = bool(np.array_equal(fast, plain))
            log("release_jpeg", subsampling=sub, restart_interval=RELEASE_JPEG_RESTART,
                size=f"{sample.shape[0]}x{sample.shape[1]}", bytes=len(data),
                cpp_ms=statistics.median(ms), plain_ms=plain_ms,
                speedup=plain_ms / statistics.median(ms), equal=equal,
                mean_abs_vs_source=float(np.abs(fast.astype(int) - sample).mean()),
                card=repr(card))
            if not equal or fast.shape != sample.shape:
                raise AssertionError(f"the C++ JPEG decoder differs from the plain one ({sub})")

        # 3. Each release through the runbook, on the card.
        def lm_rgb(src):
            return lambda scene, frame: jpeg.decode_jpeg(Path(
                f"{src}/{objects[int(scene)]}/data/color{int(frame)}.jpg").read_bytes())

        releases = (
            ("bop_json", lambda out: fx.write_bop_release(gen, objects, out, k_np),
             ["--objects", spec], lambda out, src: fx.compare_bop(gen, out, objects)),
            ("sixd_yaml", lambda out: fx.write_bop_release(gen, objects, out, k_np, form="yaml"),
             ["--objects", spec],
             lambda out, src: fx.compare_bop(gen, out, objects, form="yaml")),
            ("lm_original", lambda out: fx.write_lm_original_release(gen, objects, out), [],
             lambda out, src: fx.compare_lm_original(gen, out, objects, lm_rgb(src))),
            ("ycb_original", lambda out: fx.write_ycb_original_release(gen, objects, out, k_np),
             [], lambda out, src: fx.compare_ycb(gen, out, objects)),
        )
        converters = ((bop, "convert_bop_split"), (lm_original, "convert_lm_original"),
                      (video_data, "convert_ycb_original"), (validate, "validate"))

        def through_runbook(tag, src, argv, n_models):
            base = release_yaml(tmp, tag)
            ckpt.save_checkpoint(ckpt.checkpoint_dir(dataclasses.replace(
                update_config(base), experiment="real_data_runbook")), hl.SEED,
                hl.random_model(n_models).state_dict())
            seconds = {}
            with contextlib.ExitStack() as stack:
                for module, name in converters:
                    stack.enter_context(timed_calls(module, [name], seconds))
                text, run_s, launches, peak = run_cli(runbook.main, [
                    src, "--cfg", base, "--device", str(dev), "--out", f"{tmp}/{tag}_conv",
                    *argv])
            return text, run_s, launches, peak, seconds

        for tag, write, argv, compare in releases:
            src = f"{tmp}/{tag}"
            t0 = time.perf_counter()
            write(src)
            write_s = time.perf_counter() - t0
            text, run_s, launches, peak, seconds = through_runbook(tag, src, argv, len(objects))
            diff = compare(f"{tmp}/{tag}_conv", src)
            conv_s = sum(sum(v) for k, v in seconds.items() if k != "validate")
            records = int(_number(r"evaluated \d+ x (\d+) poses", text))
            n_batches = -(-records // bs)
            errors = len(re.findall(r"^\[ERROR\]", text, re.M))
            log("release", release=tag, frames=diff["frames"], fixture_write_s=write_s,
                convert_s=conv_s, convert_frames_per_s=diff["frames"] / conv_s,
                validate_s_each=seconds["validate"], errors=errors,
                warnings=len(re.findall(r"^\[WARN\]", text, re.M)),
                pose_max_abs=diff["pose_max_abs"], depth_max_mm=diff["depth_max_mm"],
                labels_equal=diff["labels_equal"], rgb_equal=diff["rgb_equal"],
                runbook_s=run_s, records=records, batches=n_batches,
                poses_per_s=_number(r"\(([\d.]+) poses/s", text),
                sorted_per_batch=launches["raster_sorted"] / n_batches,
                cols_per_batch=launches["raster_cols"] / n_batches, peak_mib=peak,
                mean_row=_row(text, "MEAN"), card=repr(card))
            counts[f"release_{tag}"] = launches
            if (errors or not diff["labels_equal"] or not diff["rgb_equal"]
                    or diff["pose_max_abs"] > 1e-6 or diff["depth_max_mm"] > 1):
                raise AssertionError(f"{tag}: converted root differs or fails validation: {diff}")
            if launches["raster_sorted"] != n_batches * k_iters or launches["raster_cols"]:
                raise AssertionError(f"{tag}: cli.test missed the sorted kernel: {launches}")

        # 4. The BOP release in metres stops before it is converted.
        src_m = f"{tmp}/bop_metres"
        shutil.copytree(f"{tmp}/bop_json", src_m)
        for gt_path in Path(src_m, "test").glob("*/scene_gt.json"):
            gt = json.loads(gt_path.read_text())
            for entries in gt.values():
                for e in entries:
                    e["cam_t_m2c"] = [t * 1e-3 for t in e["cam_t_m2c"]]
            gt_path.write_text(json.dumps(gt))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = runbook.main([src_m, "--cfg", release_yaml(tmp, "metres"), "--objects", spec,
                                 "--device", str(dev)])
        named = set(re.findall(r"^\[ERROR\] (\S+):", out.getvalue(), re.M))
        log("release_metres", exit_code=code, errors=sorted(named),
            converted=os.path.exists(src_m + "_converted"))
        if code != 2 or named != RELEASE_METRES_ERRORS:
            raise AssertionError(f"the BOP release in metres: exit {code}, errors {named}")

        # 5. A BOP release of 20,480-face meshes: the cols kernel.
        dense = ["icosphere_dense", "icosphere_dense2"]
        gen_d = f"{tmp}/gen_dense"
        toolkit.gen_observed(gen_d, {o: PROCEDURAL_MESHES[o]() for o in dense}, k_np, size,
                             frames_per_obj=RELEASE_DENSE_FRAMES, device=dev)
        fx.write_bop_release(gen_d, dense, f"{tmp}/bop_dense", k_np)
        text, run_s, launches, _, seconds = through_runbook(
            "bop_dense", f"{tmp}/bop_dense", ["--objects", f"1:{dense[0]},2:{dense[1]}"],
            len(dense))
        diff = fx.compare_bop(gen_d, f"{tmp}/bop_dense_conv", dense)
        n_batches = -(-len(dense) * RELEASE_DENSE_FRAMES // bs)
        counts["release_bop_dense"] = launches
        log("release_dense", faces=PROCEDURAL_MESHES[dense[0]]().num_faces,
            max_faces=cfg.dataset.max_faces, frames=diff["frames"],
            convert_s=sum(seconds["convert_bop_split"]), pose_max_abs=diff["pose_max_abs"],
            depth_max_mm=diff["depth_max_mm"], runbook_s=run_s,
            cols_per_batch=launches["raster_cols"] / n_batches,
            sorted_per_batch=launches["raster_sorted"] / n_batches, mean_row=_row(text, "MEAN"))
        if launches["raster_cols"] < n_batches or diff["depth_max_mm"] > 1:
            raise AssertionError(f"the dense BOP release missed the cols kernel: {launches}")

        # 6. MXNet weights: the seed-7 model exported and imported by the runbook.
        npz = f"{tmp}/seed7_mxnet.npz"
        export_mxnet_npz(model.state_dict(), npz)
        wtag = "weights"
        wbase = release_yaml(tmp, wtag, mxnet_pad=True)
        text_w, _, launches_w, _ = run_cli(runbook.main, [
            f"{tmp}/bop_json", "--cfg", wbase, "--weights", npz, "--objects", spec, "--device",
            str(dev), "--out", f"{tmp}/{wtag}_conv"])
        kept = int(_number(r"weights: (\d+) layers kept their init", text_w))
        cfg_w_path = f"{tmp}/{wtag}/real_data_runbook/config.yaml"
        cfg_w = update_config(cfg_w_path)
        direct = dataclasses.replace(cfg_w, experiment="direct")
        direct_path = f"{tmp}/direct.yaml"
        save_config(direct, direct_path)
        ckpt.save_checkpoint(ckpt.checkpoint_dir(direct), 0, model.state_dict())
        runs = {}
        for tag, p, exp in (("runbook", cfg_w_path, "real_data_runbook"),
                            ("direct", direct_path, "direct")):
            text, _, _, _ = run_cli(cli_test.main, ["--cfg", p, "--device", str(dev),
                                                    "--save-poses"])
            runs[tag] = (table_rows(text), np.load(f"{tmp}/{wtag}/{exp}/refined_poses.npz")["traj"])
        same = table_rows(text_w) == runs["runbook"][0] == runs["direct"][0]
        traj_equal = bool(np.array_equal(runs["runbook"][1], runs["direct"][1]))

        # One converted-root batch, card against CPU, float32, mxnet_pad on:
        # the network alone on one input, then refine_batches from
        # perturbed inits (what cli.test gets from init poses; gated) and
        # from the GT (what the runbook's cli.test ran here: printed).
        ds_w = lm6d.LM6DDataset(cfg_w.dataset.root, list(cfg_w.dataset.objects))
        recs = [r for o in cfg_w.dataset.objects for r in ds_w.gt_roidb(o, "test")]
        recs = recs[::len(recs) // RELEASE_PARITY_B][:RELEASE_PARITY_B]
        gt = np.stack([r.pose for r in recs])
        inits = {"perturbed": perturb_poses(torch.Generator().manual_seed(0),
                                            torch.from_numpy(gt)).numpy(), "gt": gt}
        _, params = ckpt.restore_checkpoint(ckpt.checkpoint_dir(cfg_w))
        k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
        net_hw = (cfg_w.network.input_height, cfg_w.network.input_width)
        sides = []
        for where in (dev, torch.device("cpu")):
            m = make_model(cfg_w, len(objects), inference=True)
            ckpt.load_params(m, params)
            m.dtype = torch.float32
            sides.append((where, m.to(where).eval(),
                          load_assets_and_names(cfg_w, eval_set=True, device=where)[0]))
        x = torch.from_numpy(np.random.RandomState(0).uniform(
            -0.5, 0.5, (RELEASE_PARITY_B, *net_hw, 6)).astype(np.float32))
        with torch.no_grad():
            outs = [m(x.to(where)) for where, m, _ in sides]
        net_diff = max((outs[0][k].cpu() - outs[1][k]).abs().max().item()
                       for k in ("rot_raw", "trans"))
        per_iter, moved = {}, 0.0
        for name, init in inits.items():
            extra = {"pose_src": init.astype(np.float32), "pose_tgt": gt,
                     "class_idx": np.array([r.class_idx for r in recs], np.int64)}
            host = next(iter(lm6d.iter_frame_batches(ds_w, recs, len(recs), pin_memory=False,
                                                     extra=extra)))
            part = {k: v.clone() for k, v in host.items() if k not in ("obs_depth", "obs_mask")}
            trajs = [cli_test.refine_batches(m, a, [part], k_cam.to(where), num_iters=k_iters,
                                             out_size=net_hw)["traj"].cpu()
                     for where, m, a in sides]
            per_iter[name] = (trajs[0] - trajs[1]).abs().flatten(1).max(1).values.tolist()
            if name == "perturbed":
                moved = (trajs[1][-1] - trajs[1][0]).abs().max().item()
        log("release_weights", layers_kept_init=kept, mxnet_pad=cfg_w.network.mxnet_pad,
            tables_equal=same, traj_equal=traj_equal, traj_shape=list(runs["direct"][1].shape),
            sorted_per_batch=launches_w["raster_sorted"] / -(-frames // bs),
            parity_rows=len(recs), network_max_diff=net_diff,
            parity_max_diff_per_iter_perturbed=per_iter["perturbed"],
            parity_max_diff_per_iter_gt_init=per_iter["gt"], parity_atol=EVAL_TRAJ_ATOL,
            moved=moved, mean_row=_row(text_w, "MEAN"))
        if not (same and traj_equal and cfg_w.network.mxnet_pad):
            raise AssertionError("the runbook's imported weights gave another table or "
                                 "trajectories than the model loaded directly")
        if (not net_diff <= EVAL_TRAJ_ATOL or not max(per_iter["perturbed"]) <= EVAL_TRAJ_ATOL
                or not moved > 1e-3):
            raise AssertionError(f"the converted model with mxnet_pad computes differently on "
                                 f"card and CPU: network {net_diff}, refine {per_iter}")


INT8_REPS = 4  # pipelined headline calls a timing, each mode timed twice in turns
INT8_LAYER_REPS = 5
INT8_NET_B = 2  # the int8 network card against CPU at 480x640
INT8_NET_RTOL = 1e-5  # of the outputs' scale: only fc_rot/fc_trans sum in another order
# refine_poses int8, card against CPU: the zoom's float32 einsums differ by
# ulps, and an ulp at a rounding boundary moves an int8 value one step (a
# step is 1/127 of a layer's range); over K=4 iterations 1.68e-3 was read
# (the first card call).  1e-2 is 3 % of how far the poses move (~0.3).
INT8_PARITY_ATOL = 1e-2
INT8_SERVE_ROWS = 16  # poses a client asks the int8_static service for
INT8_EVAL_N = 256  # cli.test --quant int8_static samples on synthetic_small
INT8_OPS_PER_S = 1.979e15  # one H100 SXM's dense int8 tensor-core peak (data sheet, 700 W)


@contextlib.contextmanager
def counting_int_mm():
    """Count the ``torch._int_mm`` calls made inside the block."""
    calls = [0]
    real = torch._int_mm

    def counted(a, b):
        calls[0] += 1
        return real(a, b)

    torch._int_mm = counted
    try:
        yield calls
    finally:
        torch._int_mm = real


def int_mm_bound(m: int, k: int, n: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of an int8 (m, k) x
    (k, n) -> int32 product, each operand read once and the result written
    once at 3.35 TB/s, against 2 m k n int8 operations at 1,979 TOP/s."""
    by_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * m * k * n / INT8_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def int8_layer_rows(model, x, reps=INT8_LAYER_REPS) -> list[dict]:
    """Per encoder conv and fc1/fc2 of the int8 ``model`` on the network
    input ``x`` (NHWC): ms of the quantize, the patch matrix, the
    ``_int_mm`` calls and the dequantize (scale, bias, leaky, cast), the
    whole int8 layer, and the bf16 cuDNN conv / linear on the same input."""
    import torch.nn.functional as F

    from deepim_tpu_torch.models import flownet as fn

    rows = []
    c = x.to(model.dtype)
    with torch.no_grad():
        for name, cout, k, s in fn.ENCODER:
            conv = getattr(model, name)
            b, h, w, cin = c.shape
            pads = (*fn.same_pad(h, k, s), *fn.same_pad(w, k, s))
            xq, sx = fn.quantize_int8(c, (1, 2, 3))
            wq, sk = fn.quantize_int8(conv.weight, (1, 2, 3))
            w_rows = wq.permute(0, 2, 3, 1).reshape(cout, -1)
            ho = (h + pads[0] + pads[1] - k) // s + 1
            wo = (w + pads[2] + pads[3] - k) // s + 1
            kp = -(-k * k * cin // 8) * 8
            chunk = max(1, fn.PATCH_BYTES // (ho * wo * kp))
            parts = [xq[b0:b0 + chunk] for b0 in range(0, b, chunk)]
            patches = [fn.im2col_int8(part, k, s, pads) for part in parts]
            acc = fn.conv_int32(xq, wq, s, pads)
            c_nchw = c.permute(0, 3, 1, 2).contiguous()
            m = b * ho * wo
            bound, by = int_mm_bound(m, kp, cout)
            rows.append({
                "layer": name, "input": f"{b}x{h}x{w}x{cin}", "m": m, "k": kp, "n": cout,
                "chunks": len(parts),
                "quantize_ms": ms_per_call(lambda: fn.quantize_int8(c, (1, 2, 3)), reps),
                "patch_ms": ms_per_call(
                    lambda: [fn.im2col_int8(pt, k, s, pads) for pt in parts], reps),
                "int_mm_ms": ms_per_call(lambda: [fn.int_mm(pt, w_rows) for pt in patches],
                                         reps),
                "dequant_ms": ms_per_call(lambda: fn.leaky(
                    (acc.float() * sx * sk.reshape(cout) + conv.bias).to(model.dtype)), reps),
                "int8_layer_ms": ms_per_call(lambda: model._qconv(name, c, False), reps),
                "bf16_ms": ms_per_call(lambda: model._conv(name, c_nchw), reps),
                "int_mm_bound_ms": bound, "bound_by": by,
            })
            del patches, acc, c_nchw
            c = model._qconv(name, c, False)
        h = c.reshape(c.shape[0], -1)  # the NHWC flatten of the full-size bottleneck
        for name in ("fc1", "fc2"):
            lin = getattr(model, name)
            xq, sx = fn.quantize_int8(h, (1,))
            wq, sk = fn.quantize_int8(lin.weight, (1,))
            bound, by = int_mm_bound(max(h.shape[0], 17), h.shape[1], lin.out_features)
            acc = fn.int_mm(xq, wq)
            rows.append({
                "layer": name, "input": "x".join(map(str, h.shape)), "m": h.shape[0],
                "k": h.shape[1], "n": lin.out_features, "chunks": 1,
                "quantize_ms": ms_per_call(lambda: fn.quantize_int8(h, (1,)), reps),
                "patch_ms": 0.0,
                "int_mm_ms": ms_per_call(lambda: fn.int_mm(xq, wq), reps),
                "dequant_ms": ms_per_call(lambda: fn.leaky(
                    acc.float() * sx * sk.reshape(1, -1) + lin.bias).to(model.dtype), reps),
                "int8_layer_ms": ms_per_call(lambda: model._qlinear(name, h), reps),
                "bf16_ms": ms_per_call(lambda: F.linear(
                    h, lin.weight.to(h.dtype), lin.bias.to(h.dtype)), reps),
                "int_mm_bound_ms": bound, "bound_by": by,
            })
            h = model._qlinear(name, h)
    return rows


def phase_int8(dev, card, rc, counts, assets, obs, init, ks, cls):
    """Phase 17: int8 inference at full width.  The headline at quant
    none / int8 / int8_static (calibrated on the headline batch, estimator
    max) in turns; the per-layer split; the int8 network and refine_poses
    card against CPU; the int8_static service; cli.test --quant
    int8_static."""
    import tempfile

    import numpy as np

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.models.flownet import ENCODER
    from deepim_tpu_torch.refine import gather_class
    from deepim_tpu_torch.refine.refiner import build_network_inputs

    base = hl.random_model(assets.num_classes).to(dev)
    models, calib_s = {}, {}
    for q in hl.QUANT_MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[q], peak = peak_memory(lambda q=q: hl.headline_model(
            base, q, assets, obs, init, ks, cls, hl.QUANT_CALIB))
        calib_s[q] = (time.perf_counter() - t0, peak)
    outs, launches, int_mm_calls, peaks = {}, {}, {}, {}
    for q, m in models.items():
        hl.run_headline(m, assets, obs, init, ks, cls)  # warm
        torch.cuda.synchronize()
        rc.reset_launches()
        with counting_int_mm() as n_mm:
            outs[q], peaks[q] = peak_memory(lambda m=m: hl.run_headline(
                m, assets, obs, init, ks, cls))
        torch.cuda.synchronize()
        launches[q] = counts[f"int8_headline_{q}"] = dict(rc.LAUNCHES)
        int_mm_calls[q] = n_mm[0]
    rates = {q: [] for q in models}
    order = list(models)
    for q in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = [hl.run_headline(models[q], assets, obs, init, ks, cls)
                   for _ in range(INT8_REPS)]
        torch.cuda.synchronize()
        rates[q].append(hl.B * INT8_REPS / (time.perf_counter() - t0))
        del pending
    for q in order:
        out = outs[q]
        log("int8", run="headline", **hl.headline_fields(q),
            poses_per_s=statistics.mean(rates[q]), poses_per_s_turns=rates[q],
            calibration_s=calib_s[q][0], calibration_peak_mib=calib_s[q][1],
            peak_mib=peaks[q], cols_launches=launches[q]["raster_cols"],
            sorted_launches=launches[q]["raster_sorted"], int_mm_calls=int_mm_calls[q],
            scales=len(models[q].act_scales),
            max_pose_diff_vs_bf16=(out - outs["none"]).abs().max().item(), card=repr(card))
        if out.shape != (hl.B, 3, 4) or not torch.isfinite(out).all():
            raise AssertionError(f"quant={q}: refined poses are not finite (B, 3, 4)")
        if not (out - init).abs().max().item() > 1e-3:
            raise AssertionError(f"quant={q}: the poses did not move")
        if launches[q]["raster_cols"] != hl.K_ITERS:
            raise AssertionError(f"quant={q}: a render missed the cols kernel: {launches[q]}")
        if q == "none" and int_mm_calls[q]:
            raise AssertionError("the bf16 headline called _int_mm")
        if q != "none" and int_mm_calls[q] < hl.K_ITERS * (len(ENCODER) + 2):
            raise AssertionError(f"quant={q}: {int_mm_calls[q]} _int_mm calls, fewer than "
                                 "one a quantized layer an iteration")

    # Where an int8 forward's time goes, layer by layer, at 480x640.
    ab = gather_class(assets, cls)
    x = build_network_inputs(base, ab, obs, init, ks, hl.SIZE).x
    for row in int8_layer_rows(models["int8"], x):
        log("int8", run="layers", size=f"{hl.SIZE[0]}x{hl.SIZE[1]}", **row, card=repr(card))
    del x

    # The int8 network card against CPU on identical inputs.
    sl = slice(0, INT8_NET_B)
    x = build_network_inputs(base, gather_class(assets, cls[sl]), obs[sl], init[sl], ks[sl],
                             hl.SIZE).x.float()
    for dtype in (torch.float32, torch.bfloat16):
        cpu = hl.random_model(assets.num_classes, dtype=dtype)
        for q in ("int8", "int8_static"):
            m_cpu = cpu.with_act_scales(models[q].act_scales)
            m_card = copy.deepcopy(m_cpu).to(dev)
            with torch.no_grad():
                got, want = m_card(x), m_cpu(x.cpu())
                c_card, c_cpu = x.to(dtype), x.cpu().to(dtype)
                for name, *_ in ENCODER:
                    c_card = m_card._qconv(name, c_card, False)
                    c_cpu = m_cpu._qconv(name, c_cpu, False)
            enc = (c_card.cpu().float() - c_cpu.float()).abs().max().item()
            errs = {key: (got[key].cpu() - want[key]).abs().max().item()
                    / max(want[key].abs().max().item(), 1e-6) for key in ("rot_raw", "trans")}
            gated = dtype == torch.float32
            log("int8", run="network_card_vs_cpu", dtype=str(dtype).split(".")[-1], quant=q,
                batch=INT8_NET_B, encoder_max_abs_diff=enc, rel_err=errs,
                rtol=INT8_NET_RTOL if gated else "printed only")
            if gated and not max(errs.values()) <= INT8_NET_RTOL:
                raise AssertionError(f"the int8 network ({q}, float32) disagrees card vs CPU")

    # refine_poses with the int8 network, card against CPU.
    model_f32 = hl.random_model(assets.num_classes, dtype=torch.float32).to(dev)
    phase_parity(model_f32.with_act_scales(()), assets, obs, init, ks, cls, case="int8",
                 atol=INT8_PARITY_ATOL)

    phase_int8_service(dev, card, rc, counts)
    phase_int8_eval(dev, card, counts)
    phase_decoders(dev, card, assets)


def phase_decoders(dev, card, assets):
    """The image readers' new formats on a 480x640 frame rendered on the
    card (the headline classes, no background noise): a progressive JPEG
    (4:2:0, restart markers; libjpeg's default scan script) and an
    Adam7-interlaced RGB PNG, each decoded in C++ against its plain
    version (arrays equal), ms a frame."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_release_fixtures as fx

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data import jpeg, png
    from deepim_tpu_torch.data.synthetic import synthetic_batch
    from deepim_tpu_torch.raster.camera import make_intrinsics

    k_cam = make_intrinsics(*hl.LINEMOD_K, device=dev)
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(hl.SEED), assets, 1, k_cam,
                            hl.SIZE, bg_noise=False)
    frame = (batch["obs_rgb"][0] * 255).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    cases = (("progressive_jpeg", fx.encode_jpeg_progressive(frame, 90, "4:2:0",
                                                             RELEASE_JPEG_RESTART),
              jpeg.decode_jpeg),
             ("adam7_png", fx.encode_png_raw(frame, 2, 8, interlace=True), png.decode_png))
    for name, data, decode in cases:
        fast = decode(data)
        t0 = time.perf_counter()
        plain = decode(data, plain=True)
        plain_ms = (time.perf_counter() - t0) * 1e3
        ms = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            decode(data)
            ms.append((time.perf_counter() - t0) * 1e3)
        equal = bool(np.array_equal(fast, plain))
        log("decoders", format=name, size=f"{frame.shape[0]}x{frame.shape[1]}",
            bytes=len(data), cpp_ms=statistics.median(ms), plain_ms=plain_ms, equal=equal,
            mean_abs_vs_source=float(np.abs(fast.astype(int) - frame).mean()), card=repr(card))
        if not equal or fast.shape != frame.shape:
            raise AssertionError(f"the C++ {name} decoder differs from the plain one")


def phase_int8_service(dev, card, rc, counts):
    """The service at the flagship config with quant int8_static: it
    calibrates at construction (two synthetic batches of B, generators
    seeded 4200 and 4201, estimator max_c); 4 clients send 16 poses each
    at once, each result against a direct refine_poses (atol 1e-3)."""
    import tempfile

    import numpy as np

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.config import config_from_dict
    from deepim_tpu_torch.refine import refine_poses
    from deepim_tpu_torch.serve import PoseRefinerService
    from deepim_tpu_torch.train import checkpoint_dir, save_checkpoint

    spec = copy.deepcopy(hl.SERVE_CONFIG)
    spec["network"] = {**spec.get("network", {}), "quant": "int8_static"}
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = config_from_dict({**spec, "output_dir": out_dir})
        save_checkpoint(checkpoint_dir(cfg), 1, hl.random_model(4).state_dict())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc, peak = peak_memory(lambda: PoseRefinerService(cfg, load_checkpoint=True))
        setup_s = time.perf_counter() - t0
    try:
        if svc.model.quant != "int8" or len(svc.model.act_scales) != 12:
            raise AssertionError("the int8_static service did not calibrate")
        obs, init, ks, cls = hl.headline_inputs(dev, svc.assets.num_classes, hl.B)
        host = [t.cpu().numpy() for t in (obs, init, ks, cls)]
        ref = refine_poses(svc.model, svc.assets, obs, init, ks, cls, num_iters=svc.num_iters,
                           out_size=hl.SIZE, coarse_iters=cfg.test.coarse_iters).cpu().numpy()

        def request(rows):
            return lambda: (rows, svc.refine(*(a[rows] for a in host)))

        n = INT8_SERVE_ROWS
        calls = [[request(slice(n * i, n * (i + 1)))] for i in range(4)]
        rc.reset_launches()
        results, wall = _serve_all(svc, calls)
        counts["int8_service"] = dict(rc.LAUNCHES)
        err = max(float(np.abs(out - ref[rows]).max()) for res in results
                  for (rows, out), _ in res)
        log("int8", run="service", quant="int8_static", calibration_mode="max_c",
            setup_s=setup_s, setup_peak_mib=peak, scales=len(svc.model.act_scales),
            requests=len(calls), poses=4 * n, wall_s=wall, launches=counts["int8_service"],
            max_abs_err_vs_direct=err, atol=PARITY_ATOL, card=repr(card))
        if not err <= PARITY_ATOL:
            raise AssertionError("the int8_static service disagrees with a direct refine_poses")
    finally:
        svc.close()


def phase_int8_eval(dev, card, counts):
    """cli.test --quant int8_static on synthetic_small.yaml (192x256, B=32,
    K=4) from a port checkpoint of seed-7 weights (pose heads with the
    headline's noise): exit 0, the calibration line and the table."""
    import tempfile

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.train import checkpoint_dir, make_model, save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = experiment_yaml(tmp, "synthetic_small.yaml")
        cfg = update_config(path)
        model = make_model(cfg, 4, inference=True, generator=torch.Generator().manual_seed(hl.SEED))
        g = torch.Generator().manual_seed(hl.SEED)
        with torch.no_grad():
            for head in (model.fc_rot, model.fc_trans):
                for p in head.parameters():
                    p.add_(torch.randn(p.shape, generator=g) * hl.HEAD_SCALE)
        save_checkpoint(checkpoint_dir(cfg), 1, model.state_dict())
        text, seconds, launches, peak = run_cli(cli_test.main, [
            "--cfg", path, "--device", str(dev), "--num-samples", str(INT8_EVAL_N),
            "--quant", "int8_static"])
    counts["int8_eval"] = launches
    calib = [ln for ln in text.splitlines() if ln.startswith("int8_static: calibrated")]
    log("int8", run="cli_test", config="synthetic_small", quant="int8_static",
        samples=INT8_EVAL_N, seconds=seconds, peak_mib=peak,
        refine_poses_per_s=_number(r"\(([\d.]+) poses/s", text), calibration=calib,
        init_row=_row(text, "[INIT]"), last_row=_row(text, f"[iter {cfg.test.test_iter}]"),
        launches=launches, card=repr(card))
    print(text[text.index("[INIT]"):], flush=True)
    if not calib:
        raise AssertionError("cli.test --quant int8_static did not calibrate")


NATIVE_SUBDIVS = (6, 7)  # icospheres of 81,920 and 327,680 faces
NATIVE_MAX_FACES = 4096
NATIVE_REPS = 3
NATIVE_DENSE_FRAMES = 4  # frames an object of the untextured 20,480-face OBJ root
NATIVE_TOOL_SAMPLES = 64
NATIVE_SUPERVISED_STEPS, NATIVE_CHECKPOINT_EVERY = 10, 5
NATIVE_NORMAL_ATOL = 4 * 2.0**-24  # numpy's normals sum in another order than the C++'s
PR8_IDLE_SHARE = 0.74  # the streamed loop's idle share with the Python decode (PR 8)


def write_obj(path: Path, mesh) -> None:
    """An untextured OBJ of ``mesh`` (``v x y z r g b`` lines, 1-based faces)."""
    lines = [f"v {x!r} {y!r} {z!r} {r!r} {g!r} {b!r}"
             for (x, y, z), (r, g, b) in zip(mesh.vertices.tolist(), mesh.colors.tolist())]
    lines += [f"f {a} {b} {c}" for a, b, c in (mesh.faces + 1).tolist()]
    path.write_text("\n".join(lines) + "\n")


def _host_ms(fn, reps=1):
    """(the median host ms of ``reps`` calls of ``fn``, its last result)."""
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), out


@contextlib.contextmanager
def counting_native(calls: dict):
    """Count the calls of ``deepim_tpu_torch.native``'s helpers (each C++
    entry point's binding) into ``calls`` while the block runs."""
    import threading

    from deepim_tpu_torch import native

    names = ("load_ply", "load_obj", "vertex_normals", "decimate", "decode_png")
    saved = {n: getattr(native, n) for n in names}
    lock = threading.Lock()  # decode_png is called from the decode pool's threads

    def counted(name):
        def call(*a, **kw):
            with lock:
                calls[name] = calls.get(name, 0) + 1
            return saved[name](*a, **kw)
        return call

    for n in names:
        setattr(native, n, counted(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(native, n, fn)


def supervised_kill_run(cfg_path: str, log_path: str, dev, steps: int,
                        timeout: float = 240.0) -> dict:
    """``tools.supervise_train`` on ``cfg_path`` (``steps`` steps on
    ``dev``), its trainer killed with SIGKILL once its first checkpoint is
    whole -> the supervisor's exit code, output, the killed step and the
    seconds.  Every process it starts is gone when it returns."""
    import re
    import signal
    import subprocess

    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.train import checkpoint_dir, latest_step

    ckpt = checkpoint_dir(update_config(cfg_path))
    cmd = [sys.executable, "-u", "-m", "deepim_tpu_torch.tools.supervise_train",
           "--cfg", cfg_path, "--log", log_path, "--poll-sec", "1", "--",
           "--num-steps", str(steps), "--device", str(dev)]
    t0 = time.perf_counter()
    sup = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                           text=True, start_new_session=True)
    lines, killed, pids = [], None, []
    try:
        for line in sup.stdout:
            lines.append(line)
            m = re.search(r"launched pid (\d+)", line)
            if m:
                pids.append(int(m.group(1)))
            if m and killed is None:
                deadline = time.perf_counter() + timeout
                while latest_step(ckpt) is None and time.perf_counter() < deadline:
                    time.sleep(0.05)
                killed = latest_step(ckpt)
                os.killpg(pids[0], signal.SIGKILL)
        code = sup.wait(timeout=timeout)
    finally:
        for pid in [sup.pid] + pids:  # the supervisor and each trainer's session
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(pid, signal.SIGKILL)
        sup.wait()
    return {"code": code, "out": "".join(lines), "killed_at": killed,
            "latest": latest_step(ckpt), "seconds": time.perf_counter() - t0}


def phase_native(dev, card, rc, counts, disk: dict, work: str):
    """Phase 18: the port's C++ host runtime and the protocol tools.

    The library built afresh (the compiler, whether ``zlib.h`` is there);
    icospheres of 81,920 and 327,680 faces as ASCII PLY and OBJ through
    load, normals and decimation to 4,096, C++ against plain (geometry
    equal, normals within 4 float32 ulps), ms of each; ``decode_png`` C++
    against plain on phase 15's frame at filter 0 and Paeth, RGB and 16-bit
    depth; ``PrefetchReader`` over phase 15's test split against
    ``open().read()``; phase 15's streamed idle share beside PR 8's; a
    root of untextured 20,480-face OBJ models decimated in C++ to 3,996
    faces, ``cli.test`` on it as two seeds (cols launches a batch, the
    C++ calls made) and ``seed_variance`` over the two; ``robustness_curve``
    and ``decimation_ab`` on the seed-7 flagship checkpoint (launches);
    ``supervise_train`` on ``synthetic_small`` with its trainer killed
    after the first checkpoint, run beside the last two (its trainers are
    processes of their own; no host time is taken while it runs)."""
    import re
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import yaml

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch import native
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.data import lm6d, png, toolkit
    from deepim_tpu_torch.raster import mesh as mesh_mod
    from deepim_tpu_torch.tools import decimation_ab, robustness_curve, seed_variance
    from deepim_tpu_torch.train import checkpoint_dir, save_checkpoint

    t_phase = time.perf_counter()
    tmp = Path(work) / "native"
    tmp.mkdir()

    # 1. The library, built afresh into a directory of its own.
    cxx = os.environ.get("CXX", "g++")
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    zlib_h = subprocess.run([cxx, "-x", "c++", "-fsyntax-only", "-"], input="#include <zlib.h>\n",
                            capture_output=True, text=True).returncode == 0
    build_dir, png.BUILD_DIR = png.BUILD_DIR, tmp / "_build"
    try:
        build_ms, so = _host_ms(native.build)
    finally:
        png.BUILD_DIR = build_dir
    log("native_build", compiler=repr(version.splitlines()[0]), zlib_h_found=zlib_h,
        flags=" ".join(native.FLAGS + native.LIBS), library=so.name, build_s=build_ms / 1e3)
    if not zlib_h:
        raise AssertionError(f"{cxx} finds no zlib.h")

    # 2. Dense meshes: load, normals, decimation, C++ against plain.
    for sub in NATIVE_SUBDIVS:
        m = mesh_mod.icosphere_mesh(0.05, subdivisions=sub)
        ply, obj = tmp / f"ico{sub}.ply", tmp / f"ico{sub}.obj"
        mesh_mod.save_ply(str(ply), m)
        write_obj(obj, m)
        for fmt, path, load in (("ply", ply, mesh_mod.load_ply), ("obj", obj, mesh_mod.load_obj)):
            cpp_ms, got = _host_ms(lambda: load(str(path)), NATIVE_REPS)
            plain_ms, want = _host_ms(lambda: load(str(path), plain=True))
            equal = all(np.array_equal(getattr(got, f), getattr(want, f))
                        for f in ("vertices", "colors", "faces"))
            nrm = float(np.abs(got.normals - want.normals).max())
            log("native_load", format=fmt, faces=got.num_faces, cpp_ms=cpp_ms, plain_ms=plain_ms,
                geometry_equal=equal, normals_max_diff=nrm, card=repr(card))
            if not equal or got.num_faces != m.num_faces or not nrm <= NATIVE_NORMAL_ATOL:
                raise AssertionError(f"the C++ {fmt} parse differs from the plain one")
        cpp_ms, got = _host_ms(lambda: native.vertex_normals(m.vertices, m.faces), NATIVE_REPS)
        plain_ms, want = _host_ms(
            lambda: mesh_mod.compute_vertex_normals(m.vertices, m.faces, plain=True))
        nrm = float(np.abs(got - want).max())
        log("native_normals", faces=m.num_faces, cpp_ms=cpp_ms, plain_ms=plain_ms,
            max_diff=nrm, atol=NATIVE_NORMAL_ATOL)
        cpp_ms, got = _host_ms(lambda: mesh_mod.decimate_mesh(m, NATIVE_MAX_FACES), NATIVE_REPS)
        plain_ms, want = _host_ms(lambda: mesh_mod.decimate_mesh(m, NATIVE_MAX_FACES, plain=True))
        same = all(np.array_equal(getattr(got, a)[got.faces], getattr(want, a)[want.faces])
                   for a in ("vertices", "colors"))
        log("native_decimate", faces=m.num_faces, to=got.num_faces, budget=NATIVE_MAX_FACES,
            cpp_ms=cpp_ms, plain_ms=plain_ms, triangles_equal=same)
        if not nrm <= NATIVE_NORMAL_ATOL or not same or got.num_faces != want.num_faces:
            raise AssertionError(f"C++ normals or decimation differ at {m.num_faces} faces")

    # 3. decode_png on phase 15's frame, filter 0 and Paeth, RGB and depth.
    rgb, depth = disk["sample"][:2]
    for name, image in (("rgb", rgb), ("depth16", depth)):
        for kind in (0, 4):
            data = encode_filtered(image, kind)
            cpp_ms, got = _host_ms(lambda: native.decode_png(data), DECODE_REPS)
            plain_ms, want = _host_ms(lambda: png.decode_png(data, plain=True))
            py_ms, _ = _host_ms(lambda: png.decode_png(data), DECODE_REPS)
            equal = (got is not None and got.dtype == want.dtype
                     and np.array_equal(got, want) and np.array_equal(got, image))
            log("native_decode", image=name, filter=kind, size=f"{image.shape[0]}x{image.shape[1]}",
                cpp_ms=cpp_ms, plain_ms=plain_ms, zlib_and_unfilter_ms=py_ms, equal=equal,
                card=repr(card))
            if not equal:
                raise AssertionError(f"decode_png of {name} filter {kind} differs")

    # 4. The prefetcher over phase 15's test split.
    ds = lm6d.LM6DDataset(disk["root"], disk["objects"])
    paths = [ds._obs(r.scene, r.frame, k) for r in disk["records"]
             for k in ("color.png", "depth.png", "label.png")]

    def prefetched():
        with native.PrefetchReader(paths, num_threads=4) as reader:
            return [data for _, data in reader]

    cpp_ms, got = _host_ms(prefetched)
    plain_ms, want = _host_ms(lambda: [Path(p).read_bytes() for p in paths])
    log("native_prefetch", files=len(paths), mib=sum(map(len, want)) / 2**20, threads=4,
        cpp_ms=cpp_ms, plain_ms=plain_ms, equal=got == want)
    if got != want:
        raise AssertionError("PrefetchReader read other bytes than open().read()")
    log("native_loader", idle_share=disk["idle_share"], pr8_idle_share=PR8_IDLE_SHARE,
        streamed_ms_per_batch=disk["streamed_ms_per_batch"],
        decode="one native.decode_png call a PNG (phase 15's disk_loop)", card=repr(card))

    # supervise_train runs beside steps 5-6 (its trainers are processes of
    # their own; no host timing is taken from here on): synthetic_small,
    # the trainer killed after its first checkpoint.
    spec = yaml.safe_load((ROOT / "experiments/cfgs/synthetic_small.yaml").read_text())
    spec["output_dir"] = str(tmp)
    spec["train"].update(log_every=1, checkpoint_every=NATIVE_CHECKPOINT_EVERY)
    p = tmp / "synthetic_small.yaml"
    p.write_text(yaml.safe_dump(spec))
    pool = ThreadPoolExecutor(1)
    supervised = pool.submit(supervised_kill_run, str(p), str(tmp / "supervise.log"), dev,
                             NATIVE_SUPERVISED_STEPS)
    pool.shutdown(wait=False)

    # 5. A root of untextured 20,480-face OBJ models, decimated in C++;
    # cli.test as two seeds, then seed_variance over the two.
    dense = ["icosphere_dense", "icosphere_dense2"]
    root = tmp / "lm6d_dense"
    d = update_config(experiment_yaml(str(tmp), "lm6d_all.yaml")).dataset
    k_np = np.array([[d.fx, 0, d.cx], [0, d.fy, d.cy], [0, 0, 1]], np.float32)
    toolkit.gen_observed(str(root), {o: mesh_mod.PROCEDURAL_MESHES[o]() for o in dense}, k_np,
                         (d.image_height, d.image_width), frames_per_obj=NATIVE_DENSE_FRAMES,
                         device=dev)
    for o in dense:
        (root / "models" / o / "textured.ply").unlink()
        write_obj(root / "models" / o / "textured.obj", mesh_mod.PROCEDURAL_MESHES[o]())
    p = disk_yaml(str(tmp), "lm6d_all.yaml", root=str(root), objects=dense)
    cfg = update_config(p)
    calls: dict = {}
    with counting_native(calls):
        a_dense = load_assets_and_names(cfg, eval_set=True, device="cpu")[0]
    n_rec = sum(len(lm6d.LM6DDataset(str(root), dense).gt_roidb(o, "test")) for o in dense)
    batches = -(-n_rec // cfg.test.batch_size)
    runs = []
    for seed in (0, 1):
        cfg_s = dataclasses.replace(cfg, experiment=f"{cfg.experiment}_seed{seed}")
        save_checkpoint(checkpoint_dir(cfg_s), hl.SEED + seed,
                        hl.random_model(len(dense), seed=hl.SEED + seed).state_dict())
        run_calls: dict = {}
        with counting_native(run_calls):
            text, seconds, launches, _ = run_cli(cli_test.main, [
                "--cfg", p, "--device", str(dev), "--seed", str(seed)])
        counts[f"native_dense_test_seed{seed}"] = launches
        runs.append(str(tmp / cfg_s.experiment))
        log("native_dense_test", seed=seed, models="20,480-face untextured OBJ",
            faces_after_load=a_dense.tri_pos.shape[2], records=n_rec, batches=batches,
            cols_per_batch=launches["raster_cols"] / batches,
            sorted_per_batch=launches["raster_sorted"] / batches, cpp_calls=run_calls,
            seconds=seconds, mean_row=_row(text, "MEAN"), card=repr(card))
        if (launches["raster_cols"] != batches * cfg.test.test_iter
                or run_calls.get("decimate", 0) != len(dense)
                or run_calls.get("decode_png", 0) < 2 * n_rec):
            raise AssertionError(f"the dense root missed the cols kernel or the C++: "
                                 f"{launches} {run_calls}")
    if a_dense.tri_pos.shape[2] != 3996 or calls.get("load_obj") != len(dense):
        raise AssertionError(f"the dense OBJs loaded to {a_dense.tri_pos.shape[2]} faces "
                             f"through {calls}")
    text, _, _, _ = run_cli(seed_variance.main, runs)
    log("native_seed_variance", runs=len(runs), sigma_row=_row(text, "sigma"))

    # 6. robustness_curve and decimation_ab on the seed-7 flagship checkpoint.
    p = experiment_yaml(str(tmp), "synthetic_all_c2f.yaml")
    cfg = update_config(p)
    save_checkpoint(checkpoint_dir(cfg), hl.SEED,
                    hl.random_model(len(cfg.dataset.objects)).state_dict())
    text, seconds, launches, _ = run_cli(robustness_curve.main, [
        "--cfg", p, "--samples", str(NATIVE_TOOL_SAMPLES), "--rot-levels", "5,30",
        "--device", str(dev)])
    counts["native_robustness_curve"] = launches
    rows = [ln for ln in text.splitlines() if re.match(r"\s+\d+\.\d+\s", ln)]
    log("native_robustness_curve", samples=NATIVE_TOOL_SAMPLES, levels="5,30", rows=rows,
        launches=launches, seconds=seconds)
    if len(rows) != 2 or not launches["raster_sorted"]:
        raise AssertionError(f"robustness_curve: rows {rows}, launches {launches}")
    out = tmp / "decimation_ab.json"
    text, seconds, launches, _ = run_cli(decimation_ab.main, [
        "--cfg", p, "--budgets", "1024,4096,0", "--samples", str(NATIVE_TOOL_SAMPLES),
        "--device", str(dev), "--results-out", str(out)])
    counts["native_decimation_ab"] = launches
    res = json.loads(out.read_text())["results"]
    faces = [r["faces"] for r in res["rows"]]
    log("native_decimation_ab", samples=res["samples"], faces=faces,
        add=[r["mean"]["add(-s)_0.1d"] for r in res["rows"]], launches=launches,
        seconds=seconds, card=repr(card))
    if faces != [1008, 3996, 20480] or not launches["raster_cols"]:
        raise AssertionError(f"decimation_ab: faces {faces}, launches {launches}")

    # 7. supervise_train (started after step 4): its trainer was killed
    # after the first checkpoint.
    sup = supervised.result()
    trainer_log = (tmp / "supervise.log").read_text()
    resumed = f"resumed from step {sup['killed_at']}" in trainer_log
    log("native_supervise", steps=NATIVE_SUPERVISED_STEPS, killed_at=sup["killed_at"],
        relaunches=sup["out"].count("resume #"), resumed=resumed, exit_code=sup["code"],
        latest_checkpoint=sup["latest"], seconds=sup["seconds"])
    if (sup["code"] != 0 or not resumed or "training complete" not in sup["out"]
            or sup["latest"] != NATIVE_SUPERVISED_STEPS):
        raise AssertionError(f"supervise_train did not recover:\n{sup['out']}")
    log("native_phase", seconds=time.perf_counter() - t_phase)


def png_filters(data: bytes) -> tuple[int, ...]:
    """The distinct row filters of a PNG's rows."""
    import struct
    import zlib

    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        hdr = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else hdr
        idat += body if kind == b"IDAT" else b""
    w, h, depth, colour = hdr[:4]
    row = w * {0: 1, 2: 3}[colour] * depth // 8
    raw = zlib.decompress(idat)
    return tuple(sorted({raw[y * (row + 1)] for y in range(h)}))


def device_busy(fn) -> tuple[float, float]:
    """torch.profiler (CUDA activity) over ``fn()`` -> (the device's busy
    ms, summed over its kernels and copies, the wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    busy = sum(dev_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return busy / 1e3, wall


def batch_host_float_ms(batch) -> float:
    """ms the host takes to convert one loader batch to float32 as the
    reference does (``astype(np.float32) / x``)."""
    import numpy as np

    rgb, dep = batch["obs_rgb"].numpy(), batch["obs_depth"].numpy().view(np.uint16)
    t0 = time.perf_counter()
    _ = rgb.astype(np.float32) / 255.0, dep.astype(np.float32) / 1000.0
    return (time.perf_counter() - t0) * 1e3


def _mat_quat(r):
    """(3, 3) rotation -> (w, x, y, z) quaternion (numpy)."""
    import numpy as np

    w = math.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    x = math.copysign(math.sqrt(max(0.0, 1.0 + r[0, 0] - r[1, 1] - r[2, 2])) / 2, r[2, 1] - r[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1.0 - r[0, 0] + r[1, 1] - r[2, 2])) / 2, r[0, 2] - r[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1.0 - r[0, 0] - r[1, 1] + r[2, 2])) / 2, r[1, 0] - r[0, 1])
    return np.array([w, x, y, z])


def _quat_mat(q):
    import numpy as np

    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


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

    t_start = time.perf_counter()
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
    PTXAS.update(ptxas_summary(info.log))

    kernels = run_phases(dev, card)
    log("done", seconds=time.perf_counter() - t_start, card=repr(card))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


class Laps:
    """``laps(name)`` logs ``[phase_time]``: the wall seconds since the
    previous lap (or since the laps began), so a run shows which phases to
    cut when the script nears its time limit."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        log("phase_time", name=name, seconds=now - self.t)
        self.t = now


def run_phases(dev, card: str) -> list[dict]:
    """Phases 3-19 on ``dev``; returns the kernels' JSON record."""
    import tempfile

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.raster import raster_cuda as rc

    laps = Laps()

    assets = hl.headline_assets(dev)
    sort_assets = hl.headline_assets(dev, dense_sphere=False)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, hl.B)
    log("setup", faces=assets.tri_pos.shape[2], sort_route_faces=sort_assets.tri_pos.shape[2],
        lod=assets.lod is not None, classes=assets.num_classes, batch=hl.B)
    record = phase_kernels(dev, assets, sort_assets, init, ks, cls, rc)
    laps("kernels")

    model_f32 = hl.random_model(assets.num_classes, dtype=torch.float32).to(dev)
    phase_parity(model_f32, assets, obs, init, ks, cls)
    laps("parity")

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
        serial_ms=[s * 1e3 for s in serial], **hl.headline_fields("none"), dtype="bf16",
        card=repr(card))
    laps("main_path_and_headline")

    # The top-k kernel, scene synthesis, the top-k route, and
    # card-against-CPU parity of the scene render and textured refinement.
    record["raster_topk"] = phase_topk_kernel(dev, assets, init, ks, cls, rc)
    tex_assets = hl.headline_assets(dev, textured=True)
    runs = synthesis_assets(dev, assets, tex_assets)
    counts.update(phase_synthesis(dev, card, rc, runs, record))
    counts.update(phase_topk_route(dev, rc, assets, tex_assets, init, ks, cls))
    phase_scene_parity(dev, rc, model_f32, runs, obs, init, ks, cls)
    laps("topk_synthesis_scene_parity")

    # The service, multi-hypothesis selection and tracking.
    phase_service(dev, card, rc, counts)
    laps("service")
    phase_selection_and_tracking(dev, card, rc, model, model_f32, assets, counts)
    laps("selection_and_tracking")

    # Training at the flagship config.
    phase_training(dev, card, rc, counts)
    laps("training")

    # Evaluation, and the video toolkit with tracking.
    phase_evaluation(dev, card, rc, counts)
    laps("evaluation")
    phase_tracking(dev, card, rc, counts)
    laps("tracking")

    with tempfile.TemporaryDirectory() as work:
        # The on-disk datasets: generation, decoding, cli.test and cli.train
        # (their roots stay in ``work`` for phase 18).
        disk = phase_disk(dev, card, rc, counts, work)
        laps("disk")

        # Public releases: converters, validator, JPEG, MXNet weights, runbook.
        phase_releases(dev, card, rc, counts)
        laps("releases")

        # int8 inference: the headline's quant modes, the int8 products layer
        # by layer, card against CPU, the int8_static service and cli.test.
        phase_int8(dev, card, rc, counts, assets, obs, init, ks, cls)
        laps("int8")

        # The C++ host runtime and the protocol tools.
        phase_native(dev, card, rc, counts, disk, work)
        laps("native")

    # Ranks: NCCL at world 1, data and tensor parallelism on this card,
    # the data-parallel eval under torchrun, the dry run, the last tools.
    phase_parallel(dev, card, counts)
    laps("parallel")

    kernels = []
    for kname, src, line, timed_case in (
            ("raster_cols", "raster_cols.cu", 418, "cols_route"),
            ("raster_sorted", "raster_sorted.cu", 758, "sort_route"),
            # The shape the top-k route's entry points give it.
            ("raster_topk", "raster_topk.cu", 857, "full_frame_render_batch")):
        main = next(r for r in record[kname]
                    if r["case"] == timed_case and r["size"] == "480x640")
        by_run = {name: c[kname] for name, c in counts.items() if c[kname]}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"deepim_tpu_torch/raster/csrc/{src}",
            "replaces": f"deepim_tpu/raster/raster_pallas.py:{line}",
            "launches": sum(by_run.values()),
            "launches_by_run": by_run,
            "max_abs_err": max(r["max_abs_err"] for r in record[kname]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "bound_share": main["bound_share"],
            # No single PyTorch call rasterizes binned face lists.
            "library_ms": None,
            "timed_case": f"{timed_case} 480x640",
            "ptxas": PTXAS.get(f"{kname}_kernel", "no nvcc log"),
        })
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on a path of the port")
    return kernels


# -- Phase 19: ranks ------------------------------------------------------------

NCCL_STEPS = 5  # fused steps of the one-rank NCCL group
NCCL_RTOL = 1e-4  # its first step against the step without a mesh (cuDNN's noise)
DP_STEPS = 10  # timed fused steps of the two gloo ranks on this card
DP_PARITY_B = 8  # the global batch of the float32 DP and TP steps at 480x640
DP_GRAD_FRAC, DP_LOSS_RTOL = 1e-3, 1e-5  # tests/test_torch_train.py's gradient tolerance
DP_EVAL_N = 256  # cli.test samples, two ranks against one process
DP_POSE_ATOL = 1e-3  # the service-against-direct gate
SCALE_FRAMES = 1024  # tools.scale_eval_demo


def _train_setup(dev, spec: dict):
    """(cfg, assets, model on ``dev`` with the phases' seed, k_cam) of ``spec``."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.config import config_from_dict
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.train import make_model

    cfg = config_from_dict(spec)
    d = cfg.dataset
    assets, _, _ = load_assets_and_names(cfg, device=dev)
    model = make_model(cfg, assets.num_classes,
                       generator=torch.Generator().manual_seed(hl.SEED)).to(dev)
    return cfg, assets, model, make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for v in tensors:
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _whole_grads(model, mesh) -> dict:
    """Every parameter's gradient, the tensor-parallel shards made whole
    on each rank (placed in zeros, summed over the model axis)."""
    import torch.distributed as dist

    from deepim_tpu_torch.parallel.mesh import MODEL_AXIS

    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    n_model, m = mesh.shape[MODEL_AXIS], mesh.model_index
    if n_model == 1:
        return grads
    for name, axis in (("fc1.weight", 0), ("fc1.bias", 0), ("fc2.weight", 1)):
        shard = grads[name]
        k = shard.shape[axis]
        shape = list(shard.shape)
        shape[axis] = k * n_model
        full = torch.zeros(shape, dtype=shard.dtype, device=shard.device)
        full.narrow(axis, m * k, k).copy_(shard)
        dist.all_reduce(full, group=mesh.model_group)
        grads[name] = full
    return grads


def _f32_spec() -> dict:
    from deepim_tpu_torch import headline as hl

    spec = copy.deepcopy(hl.TRAIN_CONFIG)
    spec.setdefault("network", {})["dtype"] = "float32"
    spec["train"].update(batch_size=DP_PARITY_B, warmup_steps=0)
    return spec


def _f32_case(dev):
    """TF32 off; the float32 config, its assets, the seeded model on
    ``dev`` and one whole batch drawn from a seed (the same on every
    rank)."""
    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.data import synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, assets, base, k_cam = _train_setup(dev, _f32_spec())
    d = cfg.dataset
    batch = synthetic_batch(torch.Generator(device=dev).manual_seed(hl.SEED), assets,
                            DP_PARITY_B, k_cam, (d.image_height, d.image_width))
    batch.pop("visible_frac", None)
    return cfg, assets, base, batch


def _one_step(cfg, assets, model, batch, mesh=None) -> tuple[dict, float]:
    """One train step of ``model`` (this rank's rows of ``batch`` under
    ``mesh``) -> (its whole gradients, its loss)."""
    from deepim_tpu_torch.parallel import shard_batch
    from deepim_tpu_torch.train import init_state, make_train_step

    state = init_state(cfg, model)
    rows = batch if mesh is None else shard_batch(mesh, batch)
    _, metrics = make_train_step(model, assets, cfg, mesh=mesh)(state, rows)
    grads = ({n: p.grad.detach().clone() for n, p in model.named_parameters()}
             if mesh is None else _whole_grads(model, mesh))
    return grads, float(metrics["loss"])


def _against_single(grads: dict, loss: float, single: tuple[dict, float]) -> dict:
    err, leaf = grad_err(grads, single[0])
    return {"grad_err": err, "grad_err_leaf": leaf, "loss": loss, "single_loss": single[1],
            "loss_rel": abs(loss - single[1]) / abs(single[1])}


def rank_nccl(dev) -> dict:
    """The one-rank NCCL group: NCCL_STEPS fused steps at TRAIN_CONFIG
    through ``mesh=``, the first against the same step without a mesh."""
    import torch.distributed as dist

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.parallel import make_mesh
    from deepim_tpu_torch.raster import raster_cuda as rc
    from deepim_tpu_torch.train import init_state, make_synthetic_train_step

    cfg, assets, model, k_cam = _train_setup(dev, hl.TRAIN_CONFIG)
    plain = copy.deepcopy(model)
    mesh = make_mesh(1, 1)
    s_mesh, s_plain = init_state(cfg, model), init_state(cfg, plain)
    step = make_synthetic_train_step(model, assets, cfg, k_cam, mesh=mesh)
    _, m0 = make_synthetic_train_step(plain, assets, cfg, k_cam)(
        s_plain, torch.Generator(device=dev).manual_seed(hl.SEED))
    del plain, s_plain
    rc.reset_launches()
    losses, norms = [], []
    for i in range(NCCL_STEPS):
        _, m = step(s_mesh, torch.Generator(device=dev).manual_seed(hl.SEED + i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"backend": dist.get_backend(), "device": str(dev), "losses": losses,
            "grad_norms": norms, "plain_loss": float(m0["loss"]),
            "plain_grad_norm": float(m0["grad_norm"]), "launches": dict(rc.LAUNCHES)}


def _timed_dp(dev, mesh) -> dict:
    """DP_STEPS timed fused steps at TRAIN_CONFIG on the two-rank data
    ``mesh`` (16 samples a rank), after two to warm up."""
    import torch.distributed as dist

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.raster import raster_cuda as rc
    from deepim_tpu_torch.train import init_state, make_synthetic_train_step
    from deepim_tpu_torch.train import train as tt

    cfg, assets, model, k_cam = _train_setup(dev, hl.TRAIN_CONFIG)
    state = init_state(cfg, model)
    step = make_synthetic_train_step(model, assets, cfg, k_cam, mesh=mesh)
    reduce_s = []
    real = tt.mean_gradients

    def timed(m, msh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(m, msh)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    tt.mean_gradients = timed
    g = torch.Generator(device=dev)
    try:
        for i in range(2):  # warm (cuDNN's choices, the allocator)
            step(state, g.manual_seed(hl.SEED + i))
        reduce_s.clear()
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        torch.cuda.reset_peak_memory_stats()
        rc.reset_launches()
        t0 = time.perf_counter()
        for i in range(DP_STEPS):
            _, metrics = step(state, g.manual_seed(hl.SEED + 100 + i))
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        wall = time.perf_counter() - t0
    finally:
        tt.mean_gradients = real
    out = {"wall_s": wall, "launches": dict(rc.LAUNCHES),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "reduce_ms": 1e3 * statistics.mean(reduce_s), "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "digest": _digest(model.state_dict().values()),
           "local_batch": cfg.train.batch_size // 2}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def rank_four(dev) -> dict:
    """Four gloo ranks on this card.  Ranks 0 and 1 take the timed DP steps
    (:func:`_timed_dp`; ranks 2 and 3 wait); then the float32 step on a
    (2, 1) and a (1, 2) mesh of ranks 0 and 1 and on a (2, 2) mesh of all
    four, each against rank 0's one-process step on the whole batch."""
    import torch.distributed as dist

    from deepim_tpu_torch.parallel import make_mesh, shard_params_for_tp

    rank = dist.get_rank()
    mesh = make_mesh(n_data=2)
    out = {"backend": dist.get_backend(), "device": str(dev)}
    if mesh.member:
        out["dp"] = _timed_dp(dev, mesh)
    dist.barrier()

    torch.cuda.reset_peak_memory_stats()
    cfg32, assets32, base, batch = _f32_case(dev)
    out["batch_digest"] = _digest(batch.values())
    single = _one_step(cfg32, assets32, copy.deepcopy(base), batch) if rank == 0 else None
    torch.cuda.empty_cache()
    out["shard_fractions"] = []
    for name, (n_data, n_model) in (("dp_2x1", (2, 1)), ("tp_1x2", (1, 2)),
                                    ("tp_2x2", (2, 2))):
        mesh = make_mesh(n_data, n_model)  # every rank makes the groups
        if not mesh.member:
            continue
        model = copy.deepcopy(base)
        if n_model > 1:
            model = shard_params_for_tp(model, mesh)
            out["shard_fractions"].append(model.fc1.weight.numel() / base.fc1.weight.numel())
        grads, loss = _one_step(cfg32, assets32, model, batch, mesh)
        if rank == 0:
            out[name] = _against_single(grads, loss, single)
        del grads, model
    out["peak_mib_f32"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def cli_test_rank(out_prefix: str, argv: list[str]) -> int:
    """One ``torch.distributed.run`` rank of ``cli.test`` (``chip_smoke.py
    --cli-test-rank <prefix> <argv>``): its exit code and raster launches
    go to ``<prefix>.rank<r>.json``."""
    sys.path.insert(0, str(ROOT))
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.raster import raster_cuda as rc

    rc.reset_launches()
    code = cli_test.main(argv)
    Path(f"{out_prefix}.rank{os.environ['RANK']}.json").write_text(
        json.dumps({"code": code, "launches": dict(rc.LAUNCHES)}))
    return code


def _check_parity(name: str, r: dict) -> None:
    if not (r["grad_err"] <= DP_GRAD_FRAC and r["loss_rel"] <= DP_LOSS_RTOL):
        raise AssertionError(f"{name}: the step misses one process's: {r}")


def phase_parallel(dev, card, counts):
    """Phase 19 (see the module docstring)."""
    import subprocess
    import tempfile

    import numpy as np

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.parallel import spawn
    from deepim_tpu_torch.parallel.distributed import free_port
    from deepim_tpu_torch.train import checkpoint_dir, save_checkpoint

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 5. The dry run and 6. scale_eval_demo start now, beside the NCCL
        # steps and the quick tools (none of them is timed).
        side = {
            "dry": subprocess.Popen(
                [sys.executable, "-m", "deepim_tpu_torch.dryrun_multichip", "2", "--device",
                 dev.type], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True),
            "scale": subprocess.Popen(
                [sys.executable, "-m", "deepim_tpu_torch.tools.scale_eval_demo", "--frames",
                 str(SCALE_FRAMES), "--root", str(Path(tmp) / "scale_lm6d"), "--device",
                 str(dev)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)}
        try:
            # 1. One rank, NCCL.
            t0 = time.perf_counter()
            (r,) = spawn(rank_nccl, 1, dev.type)
            counts["nccl_world1_train"] = r["launches"]
            first_rel = abs(r["losses"][0] - r["plain_loss"]) / abs(r["plain_loss"])
            norm_rel = (abs(r["grad_norms"][0] - r["plain_grad_norm"])
                        / abs(r["plain_grad_norm"]))
            log("ranks_nccl", world=1, backend=r["backend"], device=r["device"],
                steps=NCCL_STEPS, losses=r["losses"], grad_norms=r["grad_norms"],
                first_loss_rel=first_rel, first_grad_norm_rel=norm_rel,
                sorted_launches=r["launches"]["raster_sorted"],
                seconds=time.perf_counter() - t0, card=repr(card))
            if dev.type == "cuda" and r["backend"] != "nccl":
                raise AssertionError(f"one rank on one card is not on NCCL: {r['backend']}")
            if not (first_rel <= NCCL_RTOL and norm_rel <= NCCL_RTOL
                    and all(math.isfinite(x) for x in r["losses"])):
                raise AssertionError(f"the NCCL mesh step misses the step without a mesh: {r}")
            phase_last_tools(dev, tmp)
            done = {k: p.communicate(timeout=600) for k, p in side.items()}
        finally:
            for p in side.values():
                p.kill()
        stdout, stderr = done["dry"]
        ok = [ln for ln in stdout.splitlines() if ": OK " in ln]
        print("\n".join(ok), flush=True)
        log("ranks_dryrun", rc=side["dry"].returncode, ok_lines=len(ok),
            seconds_beside_nccl_and_tools=time.perf_counter() - t_phase)
        if (side["dry"].returncode or len(ok) != 3
                or not all(ln.endswith("backend=gloo") for ln in ok)):
            raise AssertionError(f"dryrun_multichip failed:\n{stdout[-2000:]}\n{stderr[-2000:]}")
        stdout, stderr = done["scale"]
        line = [ln for ln in stdout.splitlines() if ln.startswith("streamed eval")]
        log("tool_scale_eval_demo", frames=SCALE_FRAMES, rc=side["scale"].returncode,
            line=line[0] if line else None)
        if side["scale"].returncode or not line:
            raise AssertionError(f"scale_eval_demo failed:\n{stdout[-2000:]}\n{stderr[-2000:]}")

        # 2. Two gloo ranks on this card, timed; 3. tensor parallelism, on
        # four ranks (one spawn).
        t0 = time.perf_counter()
        four = spawn(rank_four, 4, dev.type)
        two = [r["dp"] for r in four[:2]]
        expect_sorted = 3 * DP_STEPS  # the observed frame and one crop an iteration, a step
        for i, r in enumerate(two):
            counts[f"dp_train_rank{i}"] = r["launches"]
        lead = two[0]
        log("ranks_dp", world=2, backend=four[0]["backend"],
            devices=[r["device"] for r in four[:2]], config="synthetic_all",
            size=f"{hl.SIZE[0]}x{hl.SIZE[1]}", samples_per_rank=lead["local_batch"],
            steps=DP_STEPS, samples_per_s_two_processes_one_card=(
                2 * lead["local_batch"] * DP_STEPS / max(r["wall_s"] for r in two)),
            allreduce_ms_per_step=[r["reduce_ms"] for r in two],
            peak_mib_per_rank=[r["peak_mib"] for r in two],
            sorted_launches_per_rank=[r["launches"]["raster_sorted"] for r in two],
            loss=lead["loss"], grad_norm=lead["grad_norm"],
            params_equal=len({r["digest"] for r in two}) == 1,
            note="two processes time-slice one card (two more idle): not a multi-GPU rate",
            card=repr(card))
        if any(r["backend"] != "gloo" for r in four):
            raise AssertionError("ranks that share one card must be on gloo")
        if any(r["launches"]["raster_sorted"] != expect_sorted or r["launches"]["raster_cols"]
               for r in two):
            raise AssertionError(f"a rank's renders missed the sorted kernel: "
                                 f"{[r['launches'] for r in two]}")
        if len({r["digest"] for r in two}) != 1:
            raise AssertionError("the two ranks' parameters differ after the steps")
        if len({r["batch_digest"] for r in four}) != 1:
            raise AssertionError("the ranks drew different float32 batches from one seed")
        for name in ("dp_2x1", "tp_1x2", "tp_2x2"):
            r = four[0][name]
            log("ranks_f32_step", mesh=name, batch=DP_PARITY_B,
                size=f"{hl.SIZE[0]}x{hl.SIZE[1]}", tf32=False,
                **r, tol=f"grad {DP_GRAD_FRAC} of leaf max, loss rtol {DP_LOSS_RTOL}")
            _check_parity(name, r)
        fractions = [f for r in four for f in r["shard_fractions"]]
        if fractions != [0.5] * 6:  # ranks 0 and 1 on (1, 2), all four on (2, 2)
            raise AssertionError(f"fc1's shard is not half the weight: {fractions}")
        log("ranks_tp", shard_fraction=fractions[0],
            peak_mib_f32_4_ranks=[r["peak_mib_f32"] for r in four],
            seconds=time.perf_counter() - t0)

        # 4. cli.test under torch.distributed.run against one process.
        runs = {}
        for tag in ("one", "two"):
            os.makedirs(Path(tmp) / tag)
            path = experiment_yaml(str(Path(tmp) / tag), "synthetic_all_c2f.yaml")
            cfg = update_config(path)
            save_checkpoint(checkpoint_dir(cfg), hl.SEED, hl.random_model(4).state_dict())
            runs[tag] = (path, Path(tmp) / tag / cfg.experiment)
        bs, k_iters = cfg.test.batch_size, cfg.test.test_iter
        argv = ["--device", str(dev), "--num-samples", str(DP_EVAL_N), "--save-poses"]
        text1, s1, launches1, _ = run_cli(cli_test.main, ["--cfg", runs["one"][0], *argv])
        prefix = str(Path(tmp) / "launches")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
             "--master_port", str(free_port()), str(ROOT / "chip_smoke.py"), "--cli-test-rank",
             prefix, "--cfg", runs["two"][0], *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        s2 = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"torchrun cli.test exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        ranks = [json.loads(Path(f"{prefix}.rank{i}.json").read_text()) for i in range(2)]
        for i, r in enumerate(ranks):
            counts[f"dp_eval_rank{i}"] = r["launches"]
        batches = DP_EVAL_N // bs
        traj1 = np.load(runs["one"][1] / "refined_poses.npz")["traj"]
        traj2 = np.load(runs["two"][1] / "refined_poses.npz")["traj"]
        pose_err = float(np.abs(traj1 - traj2).max())
        per_batch = [r["launches"]["raster_sorted"] / batches for r in ranks]
        log("ranks_eval", config="synthetic_all_c2f", samples=DP_EVAL_N, batch=bs,
            one_process_s=s1, two_ranks_s=s2,
            one_process_poses_per_s=_number(r"\(([\d.]+) poses/s", text1),
            two_ranks_poses_per_s=_number(r"\(([\d.]+) poses/s", proc.stdout),
            sorted_per_batch_one=launches1["raster_sorted"] / batches,
            sorted_per_batch_per_rank=per_batch, max_pose_diff=pose_err,
            one_last_row=_row(text1, f"[iter {k_iters}]"),
            two_last_row=_row(proc.stdout, f"[iter {k_iters}]"), card=repr(card))
        print("\n".join(ln for ln in text1.splitlines() if "±" in ln or "MEAN" in ln), flush=True)
        print("\n".join(ln for ln in proc.stdout.splitlines() if "±" in ln or "MEAN" in ln),
              flush=True)
        if traj1.shape != traj2.shape or not pose_err <= DP_POSE_ATOL:
            raise AssertionError(f"two-rank cli.test misses one process: {pose_err}")
        if per_batch != [1 + k_iters] * 2:
            raise AssertionError(f"a rank's eval renders missed the sorted kernel: {ranks}")
    log("ranks_done", seconds=time.perf_counter() - t_phase)


def phase_last_tools(dev, tmp: str) -> None:
    """demo_render, plot_train and gen_lm6d_cfgs (scale_eval_demo runs
    beside them as its own process)."""
    from deepim_tpu_torch.tools import demo_render, gen_lm6d_cfgs, plot_train

    t0 = time.perf_counter()
    demo = Path(tmp) / "demo"
    out, _, launches, _ = run_cli(demo_render.main, [str(demo), "--device", str(dev)])
    images = {p.name: p.stat().st_size for p in sorted(demo.iterdir())}
    log("tool_demo_render", images=images, launches=launches, seconds=time.perf_counter() - t0)
    if len(images) != 5 or not all(images.values()):
        raise AssertionError(f"demo_render wrote {images}")

    log_path = Path(tmp) / "train_log.jsonl"
    log_path.write_text(TRAIN_LOGS["synthetic_small"])
    out, _, _, _ = run_cli(plot_train.main, [str(log_path)])
    png = Path(tmp) / "train_curves.png"
    log("tool_plot_train", records=len(TRAIN_LOGS["synthetic_small"].splitlines()),
        png_bytes=png.stat().st_size, line=out.splitlines()[0])
    if not png.stat().st_size:
        raise AssertionError("plot_train wrote an empty PNG")

    cfgs = Path(tmp) / "lm6d_cfgs"
    run_cli(gen_lm6d_cfgs.main, ["--out", str(cfgs)])
    want = ROOT / "experiments" / "cfgs" / "lm6d"
    same = ({p.name: p.read_bytes() for p in cfgs.iterdir()}
            == {p.name: p.read_bytes() for p in want.iterdir()})
    log("tool_gen_lm6d_cfgs", files=len(list(cfgs.iterdir())), equal_to_committed=same)
    if not same:
        raise AssertionError("gen_lm6d_cfgs differs from experiments/cfgs/lm6d")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-test-rank"]:
        sys.exit(cli_test_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
