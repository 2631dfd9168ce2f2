"""Real-dataset-scale eval demonstration.

Port of ``tools/scale_eval_demo.py``: generates an LM6d-layout test set of
N frames (default 10,016) — synthetic observation PNGs written straight
from numpy so generation is IO-bound, with real GT pose files — then runs
the streamed eval path (``cli.test --no-refine``) over it on ``--device``
with 3,000 metric points and prints the peak host RSS.  The point: the
frames and the ADD-S distance matrices never materialize whole (a
13k-frame 480x640 f32 set is ~48 GB), so the eval's host memory stays
bounded and independent of N.

Usage:
    python -m deepim_tpu_torch.tools.scale_eval_demo [--frames 10016] [--height 64]
        [--width 128] [--root <tmp>/scale_lm6d] [--refine] [--keep] [--device cuda:0]

``--refine`` runs the full K-iteration refinement instead of
``--no-refine``.  The root defaults to ``scale_lm6d`` in the temporary
directory (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import os
import resource
import shutil
import tempfile
import time

import numpy as np


def gen_noise_dataset(root: str, num_frames: int, hw: tuple[int, int],
                      objects=("box", "icosphere")) -> None:
    """LM6d-layout test set with numpy-generated observations: noise and
    a bright disk at the projected object centre (signal enough for
    ``--vis``, none needed for the streaming demonstration); poses, labels
    and depths are real files in the exact layout, so the whole reader
    stack runs.  The reference's frames, from the same
    ``RandomState(0)`` draws."""
    from deepim_tpu_torch.data.lm6d import LM6DDataset
    from deepim_tpu_torch.raster.mesh import box_mesh, icosphere_mesh

    h, w = hw
    ds = LM6DDataset(root, list(objects))
    meshes = {"box": box_mesh((0.08, 0.1, 0.06)), "icosphere": icosphere_mesh(0.05)}
    for o in objects:
        ds.write_model(o, meshes[o])
    rng = np.random.RandomState(0)
    frames_per_obj = num_frames // len(objects)
    yy, xx = np.mgrid[:h, :w]
    disk = (xx - w // 2) ** 2 + (yy - h // 2) ** 2 < (h // 4) ** 2
    t0 = time.time()
    for ci, obj in enumerate(objects):
        frame_ids = []
        scene = f"{ci:02d}"
        for i in range(frames_per_obj):
            fid = f"{i:06d}"
            z = 0.6 + 0.3 * rng.rand()
            ang = rng.rand() * 2 * np.pi
            c, s = np.cos(ang), np.sin(ang)
            pose = np.asarray([[c, -s, 0, 0.02 * rng.randn()],
                               [s, c, 0, 0.02 * rng.randn()],
                               [0, 0, 1, z]], np.float32)
            rgb = rng.rand(h, w, 3).astype(np.float32) * 0.3
            depth = np.zeros((h, w), np.float32)
            label = np.zeros((h, w), np.uint8)
            rgb[disk] = (0.9, 0.5, 0.2)
            depth[disk] = z
            label[disk] = ci + 1
            ds.write_frame(scene, fid, rgb, depth, label, {obj: pose})
            frame_ids.append((scene, fid))
        ds.write_image_set(obj, "test", frame_ids)
    print(f"generated {num_frames} frames in {time.time() - t0:.1f}s under {root}")


def eval_config(root: str, height: int, width: int, batch_size: int) -> dict:
    """The demonstration's experiment (the reference's, with its
    ``output_dir`` under the root)."""
    return {
        "experiment": "scale_eval",
        "output_dir": os.path.join(root, "_out"),
        "network": {"input_height": height, "input_width": width, "dtype": "float32",
                    "fc_dim": 32, "with_flow": False, "with_mask": False},
        "dataset": {"name": "lm6d", "root": root, "objects": ["box", "icosphere"],
                    "image_height": height, "image_width": width, "fx": 120.0,
                    "fy": 120.0, "cx": width / 2.0, "cy": height / 2.0,
                    "num_points": 3000},
        "test": {"test_iter": 2, "batch_size": batch_size, "renderer": "pallas",
                 "init": "perturb"},
        "train": {"rot_noise_deg": 15.0, "trans_noise": [0.01, 0.01, 0.05]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10016)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "scale_lm6d"))
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--refine", action="store_true",
                    help="full refinement instead of --no-refine")
    ap.add_argument("--keep", action="store_true",
                    help="keep the generated dataset on disk")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    from deepim_tpu_torch.cli import test as cli_test
    from deepim_tpu_torch.config import config_from_dict, save_config

    if not os.path.exists(os.path.join(args.root, "image_set")):
        gen_noise_dataset(args.root, args.frames, (args.height, args.width))
    cfg_path = os.path.join(args.root, "scale_eval.yaml")
    save_config(config_from_dict(eval_config(args.root, args.height, args.width,
                                             args.batch_size)), cfg_path)

    t0 = time.time()
    argv_t = ["--cfg", cfg_path, "--device", args.device]
    if not args.refine:
        argv_t.append("--no-refine")
    rc = cli_test.main(argv_t)
    dt = time.time() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"streamed eval over {args.frames} frames x 3000 points: {dt:.1f}s, peak host RSS "
          f"{peak_gb:.2f} GB (whole-set f32 frames alone would be "
          f"{args.frames * args.height * args.width * 3 * 4 / 1e9:.1f} GB)")
    if not args.keep:
        shutil.rmtree(args.root, ignore_errors=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
