"""Preflight-validate a dataset drop (LM6d / YCB-Video / BOP).

    python -m deepim_tpu_torch.cli.validate_dataset <root> \
        [--format auto|lm6d|ycb_video|bop:<split>]

Port of ``tools/validate_dataset.py``: checks the layout, depth factors,
pose units and conventions, label ids, mesh loading and scale, and
keyframe coverage that the port's readers assume, and prints what to fix
(``data/validate.py``).  Exit code 1 if any ERROR.  Host work only.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root")
    p.add_argument("--format", default="auto", help="auto | lm6d | ycb_video | bop:<split>")
    p.add_argument("--objects", default="",
                   help="comma-separated object list (lm6d; default: infer from models/)")
    p.add_argument("--split", default="test", help="image-set split to check (lm6d)")
    args = p.parse_args(argv)

    from deepim_tpu_torch.data.validate import detect_format, format_findings, validate

    kw = {}
    fmt = args.format
    if fmt == "auto":
        fmt = detect_format(args.root)
        print(f"detected format: {fmt}")
    if fmt == "lm6d":
        kw["split"] = args.split
        if args.objects:
            kw["objects"] = args.objects.split(",")
    findings = validate(args.root, fmt, **kw)
    print(format_findings(findings))
    return 1 if any(f.level == "ERROR" for f in findings) else 0


if __name__ == "__main__":
    raise SystemExit(main())
