"""Whether the on-disk loader hides behind refinement on the card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m deepim_tpu_torch.profile_loader [--frames 64] [--passes 4] [--reps 2]

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
4. ``[contention]``: refinement of loaded batches while 4 threads spin on
   ``decode_png`` of one frame, then on ``zlib.decompress`` of 900 KB:
   what decoding on threads of the launching process costs its launches.
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

from deepim_tpu_torch import headline as hl


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_loader: no CUDA device")
    run(torch.device("cuda", 0), hl.card(), args.frames, args.passes, args.reps)
    return 0


def run(dev: torch.device, card: str, frames: int, passes: int, reps: int,
        cfg_path: str = "experiments/cfgs/lm6d_all.yaml") -> None:
    """The four readings on ``dev`` (the card; pinning needs it)."""
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
        log("setup", card=repr(card), torch=torch.__version__, records=len(recs), batch=bs,
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

        frame = Path(ds._obs(recs[0].scene, recs[0].frame, "color.png")).read_bytes()
        blob = zlib.compress(np.random.RandomState(0).randint(0, 256, 921600, np.uint8).tobytes())
        for tag, target in (("decode_png", lambda: png.decode_png(frame)),
                            ("zlib_decompress", lambda: zlib.decompress(blob))):
            with spinning(target):
                ms = best_ms_per_batch(lambda: refine(pinned), batches, reps)
            log("contention", spinning_threads=4, target=tag, refine_ms_per_batch=ms,
                card=repr(card))


if __name__ == "__main__":
    raise SystemExit(main())
