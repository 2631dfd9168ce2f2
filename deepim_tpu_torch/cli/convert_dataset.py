"""Convert a public release into the port's on-disk layouts, then preflight it.

    python -m deepim_tpu_torch.cli.convert_dataset bop <src_root> <out_root> \
        --split test --objects 1:ape,2:benchvise [--max-per-scene N]
    python -m deepim_tpu_torch.cli.convert_dataset lm_original <src_root> <out_root> \
        [--objects cat,driller] [--max-frames N]
    python -m deepim_tpu_torch.cli.convert_dataset ycb_original <src_root> <out_root> \
        --classes classes.txt [--sequences 0000,0001] [--max-per-seq N]

Port of ``tools/convert_dataset.py``: BOP/SIXD and the original LINEMOD
release become the LM6d layout (``data/bop.py``, ``data/lm_original.py``),
the original YCB-Video release the video layout
(``data/video.py §convert_ycb_original``); the output is then validated
(``data/validate.py``).  Exit code 1 if the preflight finds an ERROR.
Host work only: no device is used.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("format", choices=("bop", "lm_original", "ycb_original"))
    p.add_argument("src_root")
    p.add_argument("out_root")
    p.add_argument("--split", default="test", help="source split (bop)")
    p.add_argument("--out-split", default="test")
    p.add_argument("--objects", default="",
                   help="bop: comma list of id:name pairs; lm_original: comma list of "
                        "object dir names (default: all)")
    p.add_argument("--classes", default="",
                   help="ycb_original: text file with the release's class names in order "
                        "(one per line)")
    p.add_argument("--sequences", default="", help="ycb_original: comma list (default: all)")
    p.add_argument("--max-per-scene", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--max-per-seq", type=int, default=0)
    args = p.parse_args(argv)

    if args.format == "bop":
        from deepim_tpu_torch.data.bop import convert_bop_split

        if not args.objects:
            raise SystemExit("bop needs --objects id:name,... (BOP obj_id -> object name)")
        obj_names = {}
        for pair in args.objects.split(","):
            oid, name = pair.split(":")
            obj_names[int(oid)] = name
        ds = convert_bop_split(args.src_root, args.split, args.out_root, obj_names,
                               out_split=args.out_split,
                               max_images_per_scene=args.max_per_scene or None)
        print(f"converted BOP split '{args.split}' -> {args.out_root} "
              f"({len(ds.objects)} objects)")
    elif args.format == "lm_original":
        from deepim_tpu_torch.data.lm_original import convert_lm_original

        ds = convert_lm_original(args.src_root, args.out_root,
                                 objects=args.objects.split(",") if args.objects else None,
                                 out_split=args.out_split, max_frames=args.max_frames or None)
        print(f"converted original LINEMOD -> {args.out_root} ({len(ds.objects)} objects)")
    else:
        from deepim_tpu_torch.data.video import convert_ycb_original

        if not args.classes:
            raise SystemExit("ycb_original needs --classes <file> (the release's ordered "
                             "class-name list)")
        with open(args.classes) as f:
            class_names = [ln.strip() for ln in f if ln.strip()]
        ds = convert_ycb_original(
            args.src_root, args.out_root, class_names,
            sequences=args.sequences.split(",") if args.sequences else None,
            max_frames_per_seq=args.max_per_seq or None)
        print(f"converted original YCB-Video -> {args.out_root} "
              f"({len(ds.sequences())} sequences)")

    from deepim_tpu_torch.data.validate import format_findings, validate

    fmt = "ycb_video" if args.format == "ycb_original" else "lm6d"
    print("--- preflight on the converted output ---")
    findings = validate(args.out_root, fmt)
    print(format_findings(findings))
    return 1 if any(f.level == "ERROR" for f in findings) else 0


if __name__ == "__main__":
    raise SystemExit(main())
