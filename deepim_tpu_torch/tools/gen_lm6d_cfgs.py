"""Generate the reference's per-class experiment configs.

Port of ``tools/gen_lm6d_cfgs.py``.  mx-DeepIM ships one YAML per
(dataset, object-set) experiment under ``experiments/deepim/cfgs/`` — 13
single-class LINEMOD configs, the 8-class Occluded-LINEMOD config, and
the 21-class YCB-Video configs (training and the keyframe protocol).
This writes that tree, byte for byte the repository's
``experiments/cfgs/lm6d/``, under ``--out``.

Usage: python -m deepim_tpu_torch.tools.gen_lm6d_cfgs --out <dir>
"""

from __future__ import annotations

import argparse
import os

# The 13 LINEMOD classes of the reference's per-class protocol.
LM_CLASSES = [
    "ape", "benchvise", "camera", "can", "cat", "driller", "duck",
    "eggbox", "glue", "holepuncher", "iron", "lamp", "phone",
]
# Real BOP object ids for LINEMOD (ids 1..15; bowl=3 and cup=7 are not in
# the 13-class protocol, so positional index+1 would be wrong from
# 'camera' on).  Used to match/emit external BOP results CSVs.
LM_BOP_IDS = {
    "ape": 1, "benchvise": 2, "bowl": 3, "camera": 4, "can": 5, "cat": 6,
    "cup": 7, "driller": 8, "duck": 9, "eggbox": 10, "glue": 11,
    "holepuncher": 12, "iron": 13, "lamp": 14, "phone": 15,
}
# The 8 classes annotated in Occluded-LINEMOD.
LM_OCC_CLASSES = [
    "ape", "can", "cat", "driller", "duck", "eggbox", "glue", "holepuncher",
]
# YCB-Video's 21 objects (reference naming, BOP-style ids dropped).
YCB_CLASSES = [
    "master_chef_can", "cracker_box", "sugar_box", "tomato_soup_can",
    "mustard_bottle", "tuna_fish_can", "pudding_box", "gelatin_box",
    "potted_meat_can", "banana", "pitcher_base", "bleach_cleanser",
    "bowl", "mug", "power_drill", "wood_block", "scissors",
    "large_marker", "large_clamp", "extra_large_clamp", "foam_brick",
]
# YCB-Video camera intrinsics (the reference's cameras.yml values).
YCB_CAMERA = {"fx": 1066.778, "fy": 1067.487, "cx": 312.9869, "cy": 241.3109}


def base_cfg(experiment: str, objects: list[str], root: str) -> dict:
    return {
        "experiment": experiment,
        "dataset": {"name": "lm6d", "root": root, "objects": objects,
                    "obj_ids": [LM_BOP_IDS[o] for o in objects]
                    if all(o in LM_BOP_IDS for o in objects)
                    else list(range(1, len(objects) + 1))},
        "train": {"batch_size": 16, "num_steps": 20000, "optimizer": "adam", "lr": 3.0e-4,
                  "syn_fraction": 0.5},
        "test": {"test_iter": 4, "init": "posecnn"},
    }


def configs() -> list[tuple[str, str, dict]]:
    """(file name, header comment, config) of every experiment, in the
    reference's order."""
    out = [(f"lm6d_{cls}.yaml",
            f"# LINEMOD per-class protocol: {cls} (reference per-class cfgs).\n",
            base_cfg(f"lm6d_{cls}", [cls], "data/LM6d")) for cls in LM_CLASSES]

    occ = base_cfg("lm6d_occ", LM_OCC_CLASSES, "data/LM6d_occ")
    occ["test"]["batch_size"] = 8
    out.append(("lm6d_occ.yaml",
                "# Occluded-LINEMOD protocol: the 8 annotated classes, PoseCNN inits.\n", occ))

    ycb = base_cfg("ycb_video", YCB_CLASSES, "data/YCB_Video")
    ycb["dataset"]["name"] = "ycb"
    ycb["dataset"]["use_textures"] = "on"
    ycb["dataset"].update(YCB_CAMERA)
    out.append(("ycb_video.yaml",
                "# YCB-Video protocol: 21 textured objects, LM6d-layout on-disk training\n"
                "# (convert the release via data/bop.py).\n", ycb))

    # Keyframe evaluation protocol: the released video_sets/keyframe.txt
    # list, per-(keyframe, object) batched refinement, PoseCNN inits via
    # --posecnn-mat <results_dir> or --init-poses <bop.csv>, AUC tables.
    kf = base_cfg("ycb_keyframe", YCB_CLASSES, "data/YCB_Video")
    kf["dataset"]["name"] = "ycb_video"
    kf["dataset"]["use_textures"] = "on"
    kf["dataset"].update(YCB_CAMERA)
    kf["test"]["init"] = "posecnn"
    out.append(("ycb_keyframe.yaml",
                "# YCB-Video KEYFRAME eval protocol (reference keyframe.txt + PoseCNN inits):\n"
                "# python -m deepim_tpu.cli.test --cfg <this> --posecnn-mat <results_dir>\n",
                kf))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True,
                   help="directory to write the YAMLs to (the repository keeps them in "
                        "experiments/cfgs/lm6d)")
    args = p.parse_args(argv)
    import yaml

    os.makedirs(args.out, exist_ok=True)
    written = []
    for name, header, cfg in configs():
        path = os.path.join(args.out, name)
        with open(path, "w") as f:
            f.write(header)
            yaml.safe_dump(cfg, f, sort_keys=False)
        written.append(path)
    print(f"wrote {len(written)} configs under {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
