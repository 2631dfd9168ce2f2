"""One command for a dataset drop: detect -> convert -> validate -> weights -> eval.

    python -m deepim_tpu_torch.cli.runbook <assets_root> \
        [--out <converted_root>] [--cfg <base.yaml>] [--weights w.npz] \
        [--objects ...] [--classes file] [--num-samples N] [--dry-run] \
        [--force] [--device cuda:0]

Port of ``tools/real_data_runbook.py``:

1. **detect** the drop's layout: already converted (LM6d or video),
   BOP/SIXD (``<split>/<scene>/scene_gt.json|gt.yml``), the original
   ACCV'12 LINEMOD release (``<obj>/data/rot*.rot``), or the original
   YCB-Video release (``data/<seq>/*-color.png`` + ``image_sets/``);
2. **convert** a source release into the port's layout (``data/bop.py``,
   ``data/lm_original.py``, ``data/video.py §convert_ycb_original``);
3. **validate** it (``data/validate.py``): an ERROR stops the run with
   exit code 2 unless ``--force``.  A BOP/SIXD source is also validated
   before it is converted (``validate_bop``: mm poses and meshes, cam_K,
   depth_scale), which the reference's runbook does not do: a drop in
   metres stops there, named ``bop-t-meters``;
4. write the derived eval config next to the outputs
   (``<output_dir>/real_data_runbook/config.yaml``);
5. **weights** (optional): an MXNet tensor dump (``.npz`` with ``arg:``
   keys) laid onto ``train.make_model(cfg, ...)``'s ``state_dict`` by
   ``train/convert_mxnet.py`` and saved as a port checkpoint;
6. **eval**: ``deepim_tpu_torch.cli.test.main`` in this process, on
   ``--device`` (``cuda:0`` by default; ``cpu`` for the CPU).  Without a
   checkpoint it runs the ``--no-refine`` eval, which still proves the
   data path.

``--dry-run`` stops before the eval and prints its command.  The
conversion and validation are host work; only the eval uses the device.
"""

from __future__ import annotations

import argparse
import json
import os


def detect_release(root: str) -> str:
    """The drop's layout (``validate.detect_format``'s, plus the two source
    releases the converters read)."""
    if os.path.isdir(os.path.join(root, "video_sets")):
        return "ycb_video"
    if os.path.isdir(os.path.join(root, "data", "observed")):
        return "lm6d"
    for split in ("test", "train", "val", "test_all", "train_pbr"):
        sd = os.path.join(root, split)
        if os.path.isdir(sd):
            for scene in sorted(os.listdir(sd)):
                s = os.path.join(sd, scene)
                if (os.path.exists(os.path.join(s, "scene_gt.json"))
                        or os.path.exists(os.path.join(s, "gt.yml"))):
                    return f"bop:{split}"
    if os.path.isdir(os.path.join(root, "image_sets")) and os.path.isdir(
            os.path.join(root, "data")):
        for seq in sorted(os.listdir(os.path.join(root, "data"))):
            sd = os.path.join(root, "data", seq)
            if os.path.isdir(sd) and any(f.endswith("-color.png") for f in os.listdir(sd)):
                return "ycb_original"
    for obj in sorted(os.listdir(root)):
        od = os.path.join(root, obj, "data")
        if os.path.isdir(od) and any(f.startswith("rot") and f.endswith(".rot")
                                     for f in os.listdir(od)):
            return "lm_original"
    raise SystemExit(
        f"{root}: unrecognized layout — expected converted LM6d (data/observed/) or video "
        "(video_sets/), BOP/SIXD (<split>/<scene>/scene_gt.json|gt.yml), original LINEMOD "
        "(<obj>/data/rot*.rot), or original YCB (data/<seq>/*-color.png + image_sets/)")


def bop_object_names(root: str, spec: str) -> dict[int, str]:
    """``--objects 'id:name,...'`` if given, else the ids of
    ``models/models_info.json``."""
    if spec:
        return {int(p.split(":")[0]): p.split(":")[1] for p in spec.split(",")}
    info = os.path.join(root, "models", "models_info.json")
    if not os.path.exists(info):
        raise SystemExit("BOP drop has no models/models_info.json; pass --objects id:name,...")
    with open(info) as f:
        ids = sorted(int(k) for k in json.load(f))
    return {i: f"obj_{i:06d}" for i in ids}


def ycb_class_names(root: str, spec: str) -> list[str]:
    """The ``--classes`` file if given, else the release's
    ``image_sets/classes.txt``."""
    path = spec or os.path.join(root, "image_sets", "classes.txt")
    if not os.path.exists(path):
        raise SystemExit("original YCB drop needs the ordered class list: pass --classes "
                         "<file> (the release ships image_sets/classes.txt)")
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dataset drop: detect/convert/validate/eval")
    p.add_argument("assets_root")
    p.add_argument("--out", default="",
                   help="converted-output root (default <assets_root>_converted next to the "
                        "drop; ignored for converted drops)")
    p.add_argument("--cfg", default="",
                   help="base experiment YAML for the eval (default: the config defaults "
                        "with the converted data)")
    p.add_argument("--weights", default="",
                   help="MXNet tensor dump (.npz, arg:/aux: keys) to convert and save as "
                        "the eval checkpoint")
    p.add_argument("--objects", default="", help="BOP id:name list")
    p.add_argument("--classes", default="", help="YCB ordered class file")
    p.add_argument("--split", default="test", help="BOP source split")
    p.add_argument("--num-samples", type=int, default=0)
    p.add_argument("--force", action="store_true", help="continue past validation ERRORs")
    p.add_argument("--dry-run", action="store_true",
                   help="stop before the eval; print what would run")
    p.add_argument("--device", default="cuda:0",
                   help="torch device of the eval (default cuda:0; 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = os.path.abspath(args.assets_root)
    fmt = detect_release(root)
    print(f"[runbook] detected layout: {fmt}")

    # -- convert --------------------------------------------------------------
    out_root = root
    if fmt in ("lm6d", "ycb_video"):
        print("[runbook] already converted; skipping conversion")
        data_fmt = fmt
    elif fmt.startswith("bop"):
        from deepim_tpu_torch.data.bop import convert_bop_split
        from deepim_tpu_torch.data.validate import format_findings, validate

        # The source first: a BOP drop in metres would convert 1,000x too
        # small, which only this check names (bop-t-meters).
        findings = validate(root, fmt)
        print("[runbook] preflight of the BOP source:\n" + format_findings(findings))
        if any(f.level == "ERROR" for f in findings) and not args.force:
            print("[runbook] validation ERRORs in the source — stopping (use --force to "
                  "convert anyway)")
            return 2
        split = fmt.split(":", 1)[1]
        out_root = args.out or root.rstrip("/") + "_converted"
        ds = convert_bop_split(root, split, out_root, bop_object_names(root, args.objects))
        print(f"[runbook] converted BOP '{split}' -> {out_root} ({len(ds.objects)} objects)")
        data_fmt = "lm6d"
    elif fmt == "lm_original":
        from deepim_tpu_torch.data.lm_original import convert_lm_original

        out_root = args.out or root.rstrip("/") + "_converted"
        ds = convert_lm_original(root, out_root)
        print(f"[runbook] converted original LINEMOD -> {out_root} "
              f"({len(ds.objects)} objects)")
        data_fmt = "lm6d"
    else:  # ycb_original
        from deepim_tpu_torch.data.video import convert_ycb_original

        out_root = args.out or root.rstrip("/") + "_converted"
        ds = convert_ycb_original(root, out_root, ycb_class_names(root, args.classes))
        print(f"[runbook] converted original YCB -> {out_root} "
              f"({len(ds.sequences())} sequences)")
        data_fmt = "ycb_video"

    # -- validate ---------------------------------------------------------------
    from deepim_tpu_torch.data.validate import format_findings, validate

    findings = validate(out_root, data_fmt)
    print(format_findings(findings))
    if any(f.level == "ERROR" for f in findings):
        if not args.force:
            print("[runbook] validation ERRORs — stopping (use --force to eval anyway)")
            return 2
        print("[runbook] validation ERRORs overridden by --force")

    # -- the derived eval config ---------------------------------------------
    from deepim_tpu_torch.config import config_from_dict, save_config, update_config
    from deepim_tpu_torch.data.lm6d import LM6DDataset

    objects = LM6DDataset.discover_objects(out_root)
    if not objects:
        raise SystemExit(f"[runbook] no objects discovered under {out_root}")
    overrides = {"experiment": "real_data_runbook",
                 "dataset": {"name": "ycb_video" if data_fmt == "ycb_video" else "lm6d",
                             "root": out_root, "objects": list(objects)}}
    cfg = config_from_dict(overrides, base=update_config(args.cfg) if args.cfg else None)
    cfg_path = os.path.join(cfg.output_dir, cfg.experiment, "config.yaml")
    os.makedirs(os.path.dirname(cfg_path), exist_ok=True)
    save_config(cfg, cfg_path)
    print(f"[runbook] eval config -> {cfg_path}")

    # -- optional MXNet weights ---------------------------------------------------
    from deepim_tpu_torch.train.checkpoint import checkpoint_dir, latest_step, save_checkpoint

    ckpt_dir = checkpoint_dir(cfg)
    if args.weights:
        from deepim_tpu_torch.train.convert_mxnet import convert_mxnet_dict, load_mxnet_npz
        from deepim_tpu_torch.train.train import make_model

        model = make_model(cfg, len(objects))
        params, missing = convert_mxnet_dict(load_mxnet_npz(args.weights), model.state_dict())
        if missing:
            print(f"[runbook] weights: {len(missing)} layers kept their init "
                  f"(first: {missing[:4]})")
        save_checkpoint(ckpt_dir, 0, params)
        have_ckpt = True
        print(f"[runbook] converted weights -> {ckpt_dir}")
    else:
        have_ckpt = latest_step(ckpt_dir) is not None

    # -- eval ------------------------------------------------------------------
    eval_argv = ["--cfg", cfg_path, "--device", args.device]
    if args.num_samples:
        eval_argv += ["--num-samples", str(args.num_samples)]
    if not have_ckpt:
        eval_argv += ["--no-refine"]
        print("[runbook] no checkpoint: running the --no-refine baseline eval (data path "
              "proof); train or pass --weights for the refined numbers")
    if args.dry_run:
        print("[runbook] dry run — would now run:\n  python -m deepim_tpu_torch.cli.test "
              + " ".join(eval_argv))
        return 0
    from deepim_tpu_torch.cli import test as cli_test

    return cli_test.main(eval_argv) or 0


if __name__ == "__main__":
    raise SystemExit(main())
