"""Whether the on-disk loader hides behind refinement on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m deepim_tpu_torch.profile_loader [--frames 64] [--passes 4] [--reps 2] \
        [--tree DIR]

Generates an LM6d root at ``experiments/cfgs/lm6d_all.yaml`` on the card
(``gen_procedural_dataset``: 480x640, four classes, ``--frames`` an
object) in a temporary directory, then times batches of its test split
(``--passes`` over it, ``test.batch_size`` a batch), one line each, the
best ms a batch of ``--reps``:

1. ``[refine]``: ``cli.test.refine_batches`` on batches loaded beforehand,
   pageable and pinned (the seed-7 random model, bf16, K=4).
2. ``[loader]``: ``iter_frame_batches`` alone, through ``prefetch_iter``,
   on 1, 2, 4 and 8 decode threads.
3. ``[streamed]``: refinement fed by the loader as ``cli.test`` feeds it
   (2 and 4 threads; 4 without the prefetch thread; 4 with a 0.2 ms GIL
   switch interval).
4. ``[idle]``: the device's busy and idle share over the streamed loop (4
   threads, prefetched), from ``torch.profiler``'s CUDA activity.
5. ``[contention]``: refinement of loaded batches while 4 threads spin on
   ``png.decode_png`` of one frame (Python ``zlib`` and the C++
   unfilter), on ``native.decode_png`` (one C++ call; where the package
   has it) and on ``zlib.decompress`` of 900 KB: what decoding on threads
   of the launching process costs its launches.
6. ``[disk_test]`` and ``[disk_train]``: the on-disk entry points on the
   root, as ``chip_smoke.py`` phase 15 runs them: ``cli.test`` (its
   poses/s, warm; the seed-7 model as a port checkpoint) and
   ``TRAIN_STEPS`` of ``cli.train`` at ``syn_fraction`` 0.5 (the median
   ms of a disk step and of a synthetic one, the first of each left out,
   and the loader wait a disk step of its ``TrainBatcher``).

``--tree DIR`` measures the ``deepim_tpu_torch`` of another checkout (say,
the parent commit unpacked into a gitignored ``_parent/``) with these
readings, so two trees compare in one call, in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def best_ms_per_batch(fn, batches: int, reps: int) -> float:
    """The best of ``reps`` host ms of ``fn`` (synchronised) over ``batches``."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / batches)
    return best


@contextlib.contextmanager
def spinning(target, threads: int = 4):
    """``threads`` threads calling ``target`` in a loop while the block runs."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            target()

    ts = [threading.Thread(target=spin, daemon=True) for _ in range(threads)]
    for t in ts:
        t.start()
    try:
        yield
    finally:
        stop.set()
        for t in ts:
            t.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64, help="generated frames an object")
    ap.add_argument("--passes", type=int, default=4, help="passes over the test split")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--tree", type=Path, default=None,
                    help="measure the deepim_tpu_torch package of this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_loader: no CUDA device")
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
        for name in [m for m in sys.modules if m.split(".")[0] == "deepim_tpu_torch"]:
            del sys.modules[name]  # re-imported from the tree
    from deepim_tpu_torch import headline as hl

    run(torch.device("cuda", 0), hl.card(), args.frames, args.passes, args.reps,
        tree=str(args.tree or "."))
    return 0


def device_busy_share(fn) -> tuple[float, float]:
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
    busy = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return busy / 1e3, wall


def run(dev: torch.device, card: str, frames: int, passes: int, reps: int,
        cfg_path: str = "experiments/cfgs/lm6d_all.yaml", tree: str = ".") -> None:
    """The six readings on ``dev`` (the card; pinning needs it)."""
    import importlib.util

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.data import lm6d, png, toolkit
    from deepim_tpu_torch.raster.camera import make_intrinsics

    pin = dev.type == "cuda"
    cfg = update_config(cfg_path)
    d, bs = cfg.dataset, cfg.test.batch_size
    k_np = np.array([[d.fx, 0, d.cx], [0, d.fy, d.cy], [0, 0, 1]], np.float32)
    size = (d.image_height, d.image_width)

    with tempfile.TemporaryDirectory() as tmp:
        ds = toolkit.gen_procedural_dataset(tmp, list(d.objects), k_np, size,
                                            frames_per_obj=frames, device=dev)
        recs = [r for o in d.objects for r in ds.gt_roidb(o, "test")] * passes
        n = -(-len(recs) // bs) * bs
        recs += recs[-1:] * (n - len(recs))
        batches = n // bs
        extra = {"pose_src": np.stack([r.pose for r in recs]),
                 "pose_tgt": np.stack([r.pose for r in recs]),
                 "class_idx": np.array([r.class_idx for r in recs], np.int64)}
        cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(d, root=tmp))
        assets = load_assets_and_names(cfg, eval_set=True, device=dev)[0]
        model = hl.random_model(len(d.objects)).to(dev).eval()
        k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
        kw = {"num_iters": cfg.test.test_iter, "out_size": (cfg.network.input_height,
                                                            cfg.network.input_width)}
        log("setup", tree=tree, card=repr(card), torch=torch.__version__, records=len(recs),
            batch=bs,
            batches=batches, size=f"{size[0]}x{size[1]}", iters=kw["num_iters"])

        def stream(threads=4, pin=pin, prefetch=True):
            it = lm6d.iter_frame_batches(ds, recs, bs, pin_memory=pin, num_threads=threads,
                                         extra=extra)
            for b in lm6d.prefetch_iter(it) if prefetch else it:
                b.pop("obs_depth")
                b.pop("obs_mask")
                yield b

        def refine(source):
            cli_test.refine_batches(model, assets, source, k_cam, **kw)

        pageable = list(stream(pin=False, prefetch=False))
        pinned = [{k: v.pin_memory() if pin else v for k, v in b.items()
                   if isinstance(v, torch.Tensor)} for b in pageable]
        refine(pageable[:1])  # warm
        for tag, loaded in (("pageable", pageable), ("pinned", pinned)):
            log("refine", host=tag, ms_per_batch=best_ms_per_batch(
                lambda loaded=loaded: refine(loaded), batches, reps))
        for threads in (1, 2, 4, 8):
            log("loader", threads=threads, ms_per_batch=best_ms_per_batch(
                lambda t=threads: list(stream(threads=t)), batches, reps))
        for threads in (2, 4):
            log("streamed", threads=threads, prefetch=True, ms_per_batch=best_ms_per_batch(
                lambda t=threads: refine(stream(threads=t)), batches, reps))
        log("streamed", threads=4, prefetch=False, ms_per_batch=best_ms_per_batch(
            lambda: refine(stream(prefetch=False)), batches, reps))
        interval = sys.getswitchinterval()
        sys.setswitchinterval(0.0002)
        try:
            log("streamed", threads=4, prefetch=True, switch_interval_ms=0.2,
                ms_per_batch=best_ms_per_batch(lambda: refine(stream()), batches, reps))
        finally:
            sys.setswitchinterval(interval)
        refine(stream())  # warm the profiler's first pass
        busy, wall = device_busy_share(lambda: refine(stream()))
        log("idle", threads=4, prefetch=True, device_busy_ms=busy, wall_ms=wall,
            idle_share=1 - busy / wall, card=repr(card))

        frame = Path(ds._obs(recs[0].scene, recs[0].frame, "color.png")).read_bytes()
        blob = zlib.compress(np.random.RandomState(0).randint(0, 256, 921600, np.uint8).tobytes())
        targets = [("decode_png", lambda: png.decode_png(frame))]
        if importlib.util.find_spec("deepim_tpu_torch.native") is not None:
            from deepim_tpu_torch import native

            targets.append(("native_decode_png", lambda: native.decode_png(frame)))
        targets.append(("zlib_decompress", lambda: zlib.decompress(blob)))
        for tag, target in targets:
            with spinning(target):
                ms = best_ms_per_batch(lambda: refine(pinned), batches, reps)
            log("contention", spinning_threads=4, target=tag, refine_ms_per_batch=ms,
                card=repr(card))
        disk_entry_points(dev, card, cfg_path, tmp, ds, k_np, size)


TRAIN_STEPS = 20  # cli.train steps on disk, as chip_smoke.py phase 15 takes


def disk_entry_points(dev, card: str, cfg_path: str, root: str, ds, k_np, size,
                      train_steps: int = TRAIN_STEPS) -> None:
    """``[disk_test]`` and ``[disk_train]`` on the generated ``root``."""
    import io
    import re
    import statistics

    import yaml

    from deepim_tpu_torch import headline as hl
    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.cli import train as cli_train
    from deepim_tpu_torch.config import update_config
    from deepim_tpu_torch.data import toolkit
    from deepim_tpu_torch.raster.mesh import PROCEDURAL_MESHES
    from deepim_tpu_torch.train import checkpoint_dir, save_checkpoint
    from deepim_tpu_torch.train import train as train_mod

    spec = yaml.safe_load(Path(cfg_path).read_text())
    spec["output_dir"] = f"{root}/out"
    spec["dataset"]["root"] = root
    spec["train"].update(num_steps=train_steps, log_every=1, warmup_steps=0,
                         checkpoint_every=10 ** 6, syn_fraction=0.5)
    path = f"{root}/experiment.yaml"
    Path(path).write_text(yaml.safe_dump(spec))
    cfg = update_config(path)
    objects = list(cfg.dataset.objects)
    toolkit.gen_rendered(ds, {o: PROCEDURAL_MESHES[o]() for o in objects}, k_np, size,
                         device=dev)
    save_checkpoint(checkpoint_dir(cfg), hl.SEED, hl.random_model(len(objects)).state_dict())

    def quiet(main_fn, argv) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if main_fn(argv):
                raise RuntimeError(f"{argv} failed:\n{out.getvalue()[-2000:]}")
        return out.getvalue()

    argv = ["--cfg", path, "--device", str(dev)]
    quiet(cli_test.main, argv)  # warm
    rates = [float(re.search(r"\(([\d.]+) poses/s", quiet(cli_test.main, argv)).group(1))
             for _ in range(2)]
    log("disk_test", records=len([r for o in objects for r in ds.gt_roidb(o, "test")]),
        batch=cfg.test.batch_size, poses_per_s=max(rates), runs=rates, card=repr(card))

    step_ms = {"disk": [], "synthetic": []}
    batchers = []

    def timed(kind, make):
        def wrapped(*a, **kw):
            fn = make(*a, **kw)
            if kind == "disk":
                batchers.append(fn.batcher)

            def step(state, g):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                out = fn(state, g)
                torch.cuda.synchronize(dev)
                step_ms[kind].append((time.perf_counter() - t0) * 1e3)
                return out
            step.batcher = getattr(fn, "batcher", None)
            return step
        return wrapped

    make_disk, make_syn = cli_train.make_disk_step, train_mod.make_synthetic_train_step
    cli_train.make_disk_step = timed("disk", make_disk)
    train_mod.make_synthetic_train_step = timed("synthetic", make_syn)
    try:
        quiet(cli_train.main, argv)
    finally:
        cli_train.make_disk_step, train_mod.make_synthetic_train_step = make_disk, make_syn
    n_disk = len(step_ms["disk"])
    log("disk_train", steps=train_steps, batch=cfg.train.batch_size, disk_steps=n_disk,
        disk_step_ms=statistics.median(step_ms["disk"][1:]),
        synthetic_step_ms=statistics.median(step_ms["synthetic"][1:]),
        loader_wait_ms_per_disk_step=batchers[0].wait_s * 1e3 / max(n_disk, 1),
        card=repr(card))


if __name__ == "__main__":
    raise SystemExit(main())
