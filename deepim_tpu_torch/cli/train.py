"""Training driver: ``python -m deepim_tpu_torch.cli.train --cfg <yaml>``.

Port of ``deepim_tpu/cli/train.py`` (``parse_args``,
``load_assets_and_names``, ``main``): ``cuda:0`` unless ``--device`` names
another (``--device cpu`` for the CPU); without CUDA it raises rather than
fall back.  ``--n-devices N`` trains data-parallel on N ranks, one process
each (``parallel.launch``: spawned here, or the ranks of ``torchrun``, whose
environment then gives the world; 0 takes every visible card, and more
than the visible cards raises on CUDA; ``--device cpu`` runs N gloo ranks
on the CPU).  Every rank trains on ``batch_size / N`` samples and the
gradients are averaged (``train.make_*_step(mesh=...)``); only rank 0
prints, writes ``train_log.jsonl`` and the checkpoints, and every rank
restores them.  Synthetic and zoo configs train with the
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
batches as an uninterrupted one.  With several ranks the synthetic step
draws each rank's rows from that generator (``train.rank_generator``), and
the on-disk step's perturbation reseeds it with the rank folded in.
"""

from __future__ import annotations

import argparse
import contextlib
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
    p.add_argument("--n-devices", type=int, default=0,
                   help="data-parallel ranks, one process each (0 = every visible card; "
                        "with --device cpu, that many CPU ranks; under torchrun the "
                        "environment's world)")
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


def make_disk_step(model, assets: RenderAssets, cfg, names: list[str], k_cam: torch.Tensor,
                   mesh=None):
    """The on-disk train step: (state, generator) -> (state, metrics) on the
    next :class:`~deepim_tpu_torch.data.lm6d.TrainBatcher` batch (the
    ``train`` split of ``names`` under ``dataset.root``, shuffled from
    ``train.seed``), its GT poses perturbed by ``generator`` with the
    training noise.  Under a data-parallel ``mesh`` each rank reads its
    shard of the records at its share of the batch.  The step carries the
    batcher as ``.batcher``."""
    from deepim_tpu_torch.data.lm6d import LM6DDataset, TrainBatcher, to_device
    from deepim_tpu_torch.data.pairs import perturb_poses
    from deepim_tpu_torch.parallel.distributed import process_local_batch_size, rank, world_size
    from deepim_tpu_torch.train.train import make_train_step

    t = cfg.train
    dev = k_cam.device
    batcher = TrainBatcher(LM6DDataset(cfg.dataset.root, names), names,
                           process_local_batch_size(t.batch_size), seed=t.seed,
                           pin_memory=dev.type == "cuda", num_shards=world_size(),
                           shard_index=rank())
    train_step = make_train_step(model, assets, cfg, mesh=mesh)

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
    from deepim_tpu_torch.parallel import launch

    args = parse_args(argv)
    return launch(train, args.n_devices, args.device, args)


def train(dev: torch.device, args) -> int:
    """The training run of ``args`` on this rank (``dev``) -> 0."""
    from deepim_tpu_torch.config import save_config, update_config
    from deepim_tpu_torch.parallel import distributed, make_mesh, replicate
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.train.checkpoint import (
        checkpoint_dir, clear_checkpoints, latest_step, merge_pretrained,
        require_port_checkpoint, restore_params_raw, restore_train_state,
        save_train_state)
    from deepim_tpu_torch.train.train import init_state, make_model, make_synthetic_train_step

    cfg = update_config(args.cfg)
    if args.num_steps:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, num_steps=args.num_steps))
    if args.seed >= 0:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=args.seed),
                                  experiment=f"{cfg.experiment}_seed{args.seed}")
    d, t = cfg.dataset, cfg.train
    world, rank = distributed.world_size(), distributed.rank()
    mesh = make_mesh(n_data=world) if world > 1 else None
    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)
    out_dir = os.path.join(cfg.output_dir, cfg.experiment)
    ckpt_dir = checkpoint_dir(cfg)
    if lead:
        os.makedirs(out_dir, exist_ok=True)
        save_config(cfg, os.path.join(out_dir, "config.yaml"))
    say(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")
    say(f"devices: {world} ({dev.type}); "
        f"mesh={'1x1' if mesh is None else dict(mesh.shape)}")
    say(distributed.describe(dev))

    assets, names, _ = load_assets_and_names(cfg, device=dev)
    model = make_model(cfg, assets.num_classes,
                       generator=torch.Generator().manual_seed(t.seed)).to(dev)
    state = init_state(cfg, model)
    found = latest_step(ckpt_dir)
    distributed.barrier()  # every rank has looked before rank 0 may clear
    if args.resume and found is not None:
        restore_train_state(ckpt_dir, state)
        say(f"resumed from step {state.step}")
    else:
        if found is not None:
            say("fresh run: clearing stale checkpoints (pass --resume to continue them)")
            clear_checkpoints(ckpt_dir)
        if t.pretrained:
            # Start from another experiment's weights; whatever does not
            # fit (new heads, extra input channels) keeps its fresh init.
            require_port_checkpoint(t.pretrained, t.pretrained)
            src = restore_params_raw(t.pretrained, t.pretrained_step or None)
            merged, _ = merge_pretrained(model.state_dict(), src,
                                         reinit=tuple(t.pretrained_reinit),
                                         log=say)
            model.load_state_dict(merged)
            say(f"pretrained init from {t.pretrained}")
    if mesh is not None:
        replicate(mesh, model)  # rank 0's parameters on every rank

    k_cam = make_intrinsics(d.fx, d.fy, d.cx, d.cy, device=dev)
    syn_step = make_synthetic_train_step(model, assets, cfg, k_cam, mesh=mesh)
    syn_step_coarse = None
    if t.coarse_fraction > 0:
        # Some steps run at the coarse crop size, so the shared flatten head
        # also sees coarse features (the coarse-to-fine eval schedule).
        n = cfg.network
        cfg_c = dataclasses.replace(cfg, network=dataclasses.replace(
            n, input_height=n.coarse_height or n.input_height // 2,
            input_width=n.coarse_width or n.input_width // 2))
        syn_step_coarse = make_synthetic_train_step(model, assets, cfg_c, k_cam, mesh=mesh)

    disk_step = None
    if on_disk(d.name):
        disk_step = make_disk_step(model, assets, cfg, names, k_cam, mesh=mesh)
        say(f"on-disk training: {disk_step.batcher.num_records} frames"
            f"{f' on rank 0 of {world}' if world > 1 else ''}, syn_fraction={t.syn_fraction}")

    generator = torch.Generator(device=dev)
    t_last = time.time()
    log_path = os.path.join(out_dir, "train_log.jsonl")
    with open(log_path, "a") if lead else contextlib.nullcontext() as logf:
        for it in range(state.step, t.num_steps):
            seed = (t.seed + 1) * 1_000_003 + it
            if disk_step is not None and not frac_hit(t.syn_fraction, it):
                # the perturbation of this rank's records: a stream a rank
                _, metrics = disk_step(state, generator.manual_seed(seed * world + rank))
            else:  # the synthetic step draws each rank's rows (rank_generator)
                syn = (syn_step_coarse if syn_step_coarse is not None
                        and frac_hit(t.coarse_fraction, it) else syn_step)
                _, metrics = syn(state, generator.manual_seed(seed))
            if lead and (it + 1) % t.log_every == 0:
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
    say(f"done; checkpoints in {ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
