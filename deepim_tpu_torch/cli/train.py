"""Training driver: ``python -m deepim_tpu_torch.cli.train --cfg <yaml>``.

Port of ``deepim_tpu/cli/train.py`` (``parse_args``,
``load_assets_and_names``, ``main``) on one device: ``cuda:0`` unless
``--device`` names another (``--device cpu`` for the CPU); without CUDA it
raises rather than fall back.  Synthetic and zoo configs train with the
fused on-device synthesize-and-train step.  The on-disk datasets
(``lm6d*``, ``ycb``) interleave steps on frames from disk
(:class:`~deepim_tpu_torch.data.lm6d.TrainBatcher`, GT poses perturbed by
the step's generator, the train step on a given batch) with fused
synthetic steps: a ``train.syn_fraction`` share of steps is synthetic, in
the reference's ``frac_hit`` order.  The log line and ``train_log.jsonl``
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
    PROCEDURAL_MESHES, ZOO_FAMILIES, decimate_mesh, load_mesh, normalize_mesh,
    random_mesh_zoo, texturize)
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
    the ``modelnet`` zoo are built here; a ModelNet ``cad_dir`` evaluation
    set is every .off/.obj/.ply file there, sorted, normalised to
    ``cad_diameter`` and decimated to ``max_faces``; every other dataset
    (``lm6d*``, ``ycb*``) reads ``models/{obj}/`` under ``dataset.root``
    (``LM6DDataset.load_meshes``, decimated to ``max_faces``).
    ``texture_prob`` textures the procedural meshes; the coarse LOD
    (``lod_faces``) is built only when ``test.coarse_iters`` > 0, the only
    time it renders.
    """
    d = cfg.dataset
    names = list(d.eval_objects) if eval_set and d.eval_objects else list(d.objects)
    if d.name == "modelnet" and eval_set and d.cad_dir:
        files = sorted(fn for fn in os.listdir(d.cad_dir)
                       if os.path.splitext(fn)[1].lower() in (".off", ".obj", ".ply"))
        if not files:
            raise SystemExit(f"dataset.cad_dir={d.cad_dir!r} contains no .off/.obj/.ply "
                             "mesh files")
        names = [os.path.splitext(fn)[0] for fn in files]
        meshes = [decimate_mesh(normalize_mesh(load_mesh(os.path.join(d.cad_dir, fn)),
                                               d.cad_diameter), d.max_faces)
                  for fn in files]
    elif d.name == "modelnet" and not (eval_set and d.eval_objects):
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
        from deepim_tpu_torch.data.lm6d import LM6DDataset

        meshes = LM6DDataset(d.root, names).load_meshes(max_faces=d.max_faces)
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


def on_disk(name: str) -> bool:
    """Whether ``dataset.name`` trains on frames from disk."""
    return name.startswith("lm6d") or name == "ycb"


def make_disk_step(model, assets: RenderAssets, cfg, names: list[str], k_cam: torch.Tensor):
    """The on-disk train step: (state, generator) -> (state, metrics) on the
    next :class:`~deepim_tpu_torch.data.lm6d.TrainBatcher` batch (the
    ``train`` split of ``names`` under ``dataset.root``, shuffled from
    ``train.seed``), its GT poses perturbed by ``generator`` with the
    training noise.  The step carries the batcher as ``.batcher``."""
    from deepim_tpu_torch.data.lm6d import LM6DDataset, TrainBatcher, to_device
    from deepim_tpu_torch.data.pairs import perturb_poses
    from deepim_tpu_torch.train.train import make_train_step

    t = cfg.train
    dev = k_cam.device
    batcher = TrainBatcher(LM6DDataset(cfg.dataset.root, names), names, t.batch_size,
                           seed=t.seed, pin_memory=dev.type == "cuda")
    train_step = make_train_step(model, assets, cfg)

    def step(state, generator: torch.Generator):
        batch = to_device(batcher.next(), dev)
        batch["pose_src"] = perturb_poses(
            generator, batch["pose_tgt"], rot_std_deg=t.rot_noise_deg,
            rot_max_deg=t.rot_noise_max_deg, trans_std=tuple(t.trans_noise),
            trans_max=tuple(t.trans_noise_max))
        batch["k"] = k_cam.expand(batch["pose_tgt"].shape[0], 3, 3).contiguous()
        return train_step(state, batch)

    step.batcher = batcher
    return step


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
    dev = _device(args.device)
    out_dir = os.path.join(cfg.output_dir, cfg.experiment)
    ckpt_dir = checkpoint_dir(cfg)
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, "config.yaml"))
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")

    assets, names, _ = load_assets_and_names(cfg, device=dev)
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

    disk_step = None
    if on_disk(d.name):
        disk_step = make_disk_step(model, assets, cfg, names, k_cam)
        print(f"on-disk training: {disk_step.batcher.num_records} frames, "
              f"syn_fraction={t.syn_fraction}")

    generator = torch.Generator(device=dev)
    t_last = time.time()
    log_path = os.path.join(out_dir, "train_log.jsonl")
    with open(log_path, "a") as logf:
        for it in range(state.step, t.num_steps):
            generator.manual_seed((t.seed + 1) * 1_000_003 + it)
            if disk_step is not None and not frac_hit(t.syn_fraction, it):
                _, metrics = disk_step(state, generator)
            elif syn_step_coarse is not None and frac_hit(t.coarse_fraction, it):
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
