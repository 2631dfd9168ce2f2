"""Where the headline's time goes on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m deepim_tpu_torch.profile_headline [--reps 5] [--trace out.json]

Three readings of the headline protocol (:mod:`deepim_tpu_torch.headline`:
B=128, bf16 network, random weights from a seed), one line per row:

1. ``[stages]``: one refine iteration at each crop size, stage by stage in
   ``refine_step``'s order with a synchronise after each stage, median ms
   of ``--reps``; beside it the whole ``refine_step`` timed the same way.
2. ``[layers]``: each encoder conv (SAME pad, conv, bias, leaky ReLU) at
   each crop size, CUDA events, median ms of ``--reps``.
3. ``[trace]``: ``torch.profiler`` over one whole ``refine_poses``: the
   device's busy time against the call's wall time, and the kernels that
   take the most device time.  ``--trace`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from deepim_tpu_torch import headline as hl
from deepim_tpu_torch.geometry.delta_pose import DeltaPose, apply_delta
from deepim_tpu_torch.models.flownet import ENCODER, decode_rot, network_input, select_class
from deepim_tpu_torch.ops.zoom import compute_zoom_box, zoom_image_batch, zoom_intrinsics
from deepim_tpu_torch.raster import raster_cuda as rc
from deepim_tpu_torch.refine import gather_class, refine_step
from deepim_tpu_torch.refine.refiner import _TRANS_CLIP


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def synced_ms(fn, reps: int):
    """(median host ms of ``fn`` with a synchronise on each side, last result)."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def event_ms(fn, reps: int) -> float:
    """Median device ms of ``fn`` between two CUDA events, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stage_times(model, ab, obs, pose, ks, cls, size, reps):
    """ms of each stage of one refine iteration at ``size`` -> (rows, x)."""
    h, w = size
    cols = ab.tri_pos.shape[2] >= rc._COLS_MIN_FACES_CROP
    rows = {}

    def stage(name, fn):
        rows[name], out = synced_ms(fn, reps)
        return out

    def zoom_box():
        box = compute_zoom_box(pose, ks, ab.corners, size)
        return box, zoom_intrinsics(ks, box)

    box, kz = stage("zoom box", zoom_box)
    params, bbox, ok = stage("plane packing", lambda: rc.pack_tri_params(
        ab.tri_pos, ab.tri_col, ab.tri_nrm, pose, kz, rc.FLAT_LIGHTING, 0.01,
        ab.cull_dir))
    if cols:
        binned = stage("binning", lambda: rc.bin_faces_packed(bbox, ok, size))
        overflow = stage("overflow .item()", lambda: int(binned[2][:, -1].max()))
        rgb, _ = stage("raster_cols kernel", lambda: rc.raster_cols(params, *binned, h, w))
    else:
        binned = stage("binning", lambda: rc.bin_faces_sorted(bbox, ok, size, 8, 3))
        overflow = None
        rgb, _ = stage("raster_sorted kernel",
                       lambda: rc.raster_sorted(params, *binned, h, w))
    obs_crop = stage("zoom of the observed image", lambda: zoom_image_batch(obs, box, size))
    x = stage("network input concat",
              lambda: network_input(obs_crop, rgb.permute(0, 2, 3, 1)))
    out = stage("network", lambda: model(x))

    def compose():
        quat = decode_rot(select_class(out["rot_raw"], cls), model.rot_type)
        trans = select_class(out["trans"], cls)
        clip = torch.tensor(_TRANS_CLIP, dtype=trans.dtype, device=trans.device)
        return apply_delta(pose, DeltaPose(quat, trans.clamp(-clip, clip)), kz)

    stage("compose", compose)
    whole, _ = synced_ms(lambda: refine_step(model, ab, obs, pose, ks, cls, size), reps)
    return rows, whole, overflow, x


def layer_times(model, x, reps):
    """ms of each encoder conv on the network input ``x`` -> [(name, shape, ms)]."""
    c = x.to(model.dtype).permute(0, 3, 1, 2)
    rows = []
    with torch.no_grad():
        for name, *_ in ENCODER:
            rows.append((name, "x".join(map(str, c.shape[1:])),
                         event_ms(lambda c=c, name=name: model._conv(name, c), reps)))
            c = model._conv(name, c)
    return rows


def trace(model, assets, obs, init, ks, cls, path, top=12):
    """torch.profiler over one refine_poses -> device busy ms, wall ms, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    hl.run_headline(model, assets, obs, init, ks, cls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hl.run_headline(model, assets, obs, init, ks, cls)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if path:
        prof.export_chrome_trace(path)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e3
    return busy, wall, [(e.key, e.count, dev_us(e) / 1e3) for e in kernels[:top]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=hl.B)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_headline: no CUDA device")
    dev = torch.device("cuda", 0)
    card = hl.card()
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        batch=args.batch, reps=args.reps)

    assets = hl.headline_assets(dev)
    obs, init, ks, cls = hl.headline_inputs(dev, assets.num_classes, args.batch)
    model = hl.random_model(assets.num_classes).to(dev)
    hl.run_headline(model, assets, obs, init, ks, cls)  # warm
    ab = gather_class(assets, cls)
    ab_coarse = gather_class(assets.lod, cls) if assets.lod is not None else ab

    inputs = {}
    for size, a in ((hl.SIZE, ab), (hl.COARSE, ab_coarse)):
        rows, whole, overflow, inputs[size] = stage_times(
            model, a, obs, init, ks, cls, size, args.reps)
        tag = f"{size[0]}x{size[1]}"
        for name, ms in rows.items():
            log("stages", size=tag, stage=repr(name), ms=ms)
        log("stages", size=tag, sum_of_stages_ms=sum(rows.values()),
            refine_step_ms=whole, faces=a.tri_pos.shape[2],
            global_faces_uncapped_max=overflow)
    for size, x in inputs.items():
        for name, shape, ms in layer_times(model, x, args.reps):
            log("layers", size=f"{size[0]}x{size[1]}", layer=name, input=shape, ms=ms)

    busy, wall, top = trace(model, assets, obs, init, ks, cls, args.trace)
    log("trace", device_busy_ms=busy, wall_ms=wall,
        idle_share=(1 - busy / wall) if wall else None, card=repr(card))
    for key, count, ms in top:
        log("trace", kernel=repr(key[:90]), calls=count, device_ms=ms)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
