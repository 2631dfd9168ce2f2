"""Training driver: ``python -m deepim_tpu_torch.cli.train --cfg <yaml>``.

Port of ``deepim_tpu/cli/train.py`` (``parse_args``,
``load_assets_and_names``, ``main``) on one device: ``cuda:0`` unless
``--device`` names another (``--device cpu`` for the CPU); without CUDA it
raises rather than fall back.  Synthetic and zoo configs train with the
fused on-device synthesize-and-train step; the on-disk datasets (``lm6d``,
``ycb``) are ROADMAP A13 and raise.  The log line and ``train_log.jsonl``
keep the reference's format (``tools/plot_train.py`` reads both
packages'); checkpoints go to
``<output_dir>/<experiment>/checkpoints_torch/``.

Where the reference splits one JAX key per step, each step here reseeds
one device generator from (seed, step), so a resumed run draws the same
batches as an uninterrupted one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time

import numpy as np
import torch

from deepim_tpu_torch.geometry.symmetry import (
    CONTINUOUS_Z, LINEMOD_SYMMETRIC, PROCEDURAL_SYMMETRIC, YCB_SYMMETRIC)
from deepim_tpu_torch.raster.mesh import (
    PROCEDURAL_MESHES, ZOO_FAMILIES, random_mesh_zoo, texturize)
from deepim_tpu_torch.refine.refiner import RenderAssets, build_assets

# Zoo families that are continuously z-symmetric, like their canonical
# shapes.
_CONTINUOUS_ZOO = ("zoo_cyl", "zoo_torus", "zoo_cone", "zoo_capsule", "zoo_frustum",
                   "zoo_tube")


def _symmetry(name: str, table: dict):
    if name.startswith(_CONTINUOUS_ZOO):
        return CONTINUOUS_Z
    # Dense stand-ins share their base shape's symmetry.
    return table.get(re.sub(r"_dense\d*$", "", name), table.get(name))


def load_assets_and_names(cfg, eval_set: bool = False,
                          device: torch.device | str = "cuda"
                          ) -> tuple[RenderAssets, list[str], list[bool]]:
    """Meshes per ``cfg.dataset`` -> (RenderAssets on ``device``, class
    names, symmetric flags).

    ``eval_set`` selects ``cfg.dataset.eval_objects`` when there are any
    (the ModelNet unseen-category protocol).  ``synthetic*`` datasets and
    the ``modelnet`` zoo are built here; the datasets read from disk
    (``lm6d``, ``ycb``, a ModelNet ``cad_dir``) need the mesh loaders,
    which are not ported yet, and raise ``NotImplementedError`` rather
    than serve other meshes.  ``texture_prob`` textures the procedural
    meshes; the coarse LOD (``lod_faces``) is built only when
    ``test.coarse_iters`` > 0, the only time it renders.
    """
    d = cfg.dataset
    names = list(d.eval_objects) if eval_set and d.eval_objects else list(d.objects)
    if d.name == "modelnet" and eval_set and d.cad_dir:
        raise NotImplementedError(
            "dataset.cad_dir: loading CAD meshes from disk is not ported yet "
            "(ROADMAP A13)")
    if d.name == "modelnet" and not (eval_set and d.eval_objects):
        zoo = random_mesh_zoo(d.zoo_size, d.zoo_seed, tuple(d.zoo_families) or ZOO_FAMILIES,
                              texture_prob=d.texture_prob)
        names = list(zoo)
        meshes = [zoo[n] for n in names]
    elif d.name.startswith("synthetic") or d.name == "modelnet":
        meshes = [PROCEDURAL_MESHES[n]() for n in names]
        if d.texture_prob > 0.0:
            rng_tex = np.random.RandomState(d.zoo_seed)
            meshes = [texturize(m, d.zoo_seed * 100003 + i)
                      if rng_tex.rand() < d.texture_prob else m
                      for i, m in enumerate(meshes)]
    else:
        raise NotImplementedError(
            f"dataset.name={d.name!r}: the on-disk dataset loaders are not "
            "ported yet (ROADMAP A13)")
    table = {**LINEMOD_SYMMETRIC, **YCB_SYMMETRIC, **PROCEDURAL_SYMMETRIC}
    syms = [_symmetry(n, table) for n in names]
    use_tex = {"auto": None, "on": True, "off": False}[d.use_textures]
    lod = d.lod_faces if cfg.test.coarse_iters > 0 else None
    assets = build_assets(meshes, sym_transforms=syms, num_points=d.num_points,
                          use_textures=use_tex, lod_faces=lod or None, device=device)
    return assets, names, [s is not None for s in syms]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a deepim_tpu_torch model")
    p.add_argument("--cfg", required=True, help="experiment YAML")
    p.add_argument("--num-steps", type=int, default=0,
                   help="override cfg.train.num_steps")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--seed", type=int, default=-1,
                   help="override cfg.train.seed; also suffixes the experiment "
                        "dir with _seed<k> so runs don't clobber each other")
    p.add_argument("--device", default="cuda:0",
                   help="torch device to train on (default cuda:0; 'cpu' for the CPU)")
    return p.parse_args(argv)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device; pass --device cpu to "
                           "train on the CPU")
    return dev


def frac_hit(frac: float, it: int) -> bool:
    """Whether step ``it`` is one of a deterministic ``frac`` share of steps
    (host-side counter: no device read)."""
    return (int(frac * (it + 1)) - int(frac * it)) == 1


def main(argv=None) -> int:
    from deepim_tpu_torch.config import save_config, update_config
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.train.checkpoint import (
        checkpoint_dir, clear_checkpoints, latest_step, merge_pretrained,
        require_port_checkpoint, restore_params_raw, restore_train_state,
        save_train_state)
    from deepim_tpu_torch.train.train import init_state, make_model, make_synthetic_train_step

    args = parse_args(argv)
    cfg = update_config(args.cfg)
    if args.num_steps:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, num_steps=args.num_steps))
    if args.seed >= 0:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=args.seed),
                                  experiment=f"{cfg.experiment}_seed{args.seed}")
    d, t = cfg.dataset, cfg.train
    if d.name.startswith("lm6d") or d.name == "ycb":
        raise NotImplementedError(
            f"dataset.name={d.name!r}: on-disk training (TrainBatcher, syn_fraction) "
            "is not ported yet (ROADMAP A13)")
    dev = _device(args.device)
    out_dir = os.path.join(cfg.output_dir, cfg.experiment)
    ckpt_dir = checkpoint_dir(cfg)
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, "config.yaml"))
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")

    assets, _, _ = load_assets_and_names(cfg, device=dev)
    model = make_model(cfg, assets.num_classes,
                       generator=torch.Generator().manual_seed(t.seed)).to(dev)
    state = init_state(cfg, model)
    if args.resume and latest_step(ckpt_dir) is not None:
        restore_train_state(ckpt_dir, state)
        print(f"resumed from step {state.step}")
    else:
        if latest_step(ckpt_dir) is not None:
            print("fresh run: clearing stale checkpoints (pass --resume to continue them)")
            clear_checkpoints(ckpt_dir)
        if t.pretrained:
            # Start from another experiment's weights; whatever does not
            # fit (new heads, extra input channels) keeps its fresh init.
            require_port_checkpoint(t.pretrained, t.pretrained)
            src = restore_params_raw(t.pretrained, t.pretrained_step or None)
            merged, _ = merge_pretrained(model.state_dict(), src,
                                         reinit=tuple(t.pretrained_reinit))
            model.load_state_dict(merged)
            print(f"pretrained init from {t.pretrained}")

    k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
    syn_step = make_synthetic_train_step(model, assets, cfg, k_cam)
    syn_step_coarse = None
    if t.coarse_fraction > 0:
        # Some steps run at the coarse crop size, so the shared flatten head
        # also sees coarse features (the coarse-to-fine eval schedule).
        n = cfg.network
        cfg_c = dataclasses.replace(cfg, network=dataclasses.replace(
            n, input_height=n.coarse_height or n.input_height // 2,
            input_width=n.coarse_width or n.input_width // 2))
        syn_step_coarse = make_synthetic_train_step(model, assets, cfg_c, k_cam)

    generator = torch.Generator(device=dev)
    t_last = time.time()
    log_path = os.path.join(out_dir, "train_log.jsonl")
    with open(log_path, "a") as logf:
        for it in range(state.step, t.num_steps):
            generator.manual_seed((t.seed + 1) * 1_000_003 + it)
            if syn_step_coarse is not None and frac_hit(t.coarse_fraction, it):
                _, metrics = syn_step_coarse(state, generator)
            else:
                _, metrics = syn_step(state, generator)
            if (it + 1) % t.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                t_last = time.time()
                print(f"step {it + 1}/{t.num_steps} "
                      f"loss={metrics['loss']:.5f} "
                      f"rot={metrics['rot_err_deg_0']:.2f}deg "
                      f"trans={metrics['trans_err_0'] * 100:.2f}cm "
                      f"({t.log_every / dt * t.batch_size:.1f} samples/s)", flush=True)
                logf.write(json.dumps({"step": it + 1, **metrics}) + "\n")
                logf.flush()
            if (it + 1) % t.checkpoint_every == 0 or it + 1 == t.num_steps:
                save_train_state(ckpt_dir, state)
    print(f"done; checkpoints in {ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
