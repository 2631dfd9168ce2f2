"""Multi-rank dry run: ``python -m deepim_tpu_torch.dryrun_multichip N [--device cuda|cpu]``.

Port of ``__graft_entry__.py §dryrun_multichip``: N ranks (``parallel.spawn``,
placed and given a backend by ``parallel.distributed.placement``) run the
full training step and the refine loop at tiny shapes (64x128, fc_dim 64,
float32, a box and a sphere), three ways:

1. data parallelism over an (N, 1) mesh: the fused synthesize-and-train
   step, each rank drawing its 2 samples, gradients and metrics averaged;
2. data and tensor parallelism over an (N//2, 2) mesh: the train step on a
   given batch of 2N, each data rank training on its rows, the pose head's
   fc1 and fc2 split over the model axis (``shard_params_for_tp``);
3. data-parallel evaluation over (N,): ``refine_poses`` (2 iterations) on
   each rank's rows of a batch of 2N, the rows gathered by one all-reduce.

Rank 0 prints one ``OK`` line for each, with the loss, the mesh and the
backend; any failure raises and fails the run.
"""

from __future__ import annotations

import argparse
import copy

import torch

H, W = 64, 128


def _cfg(n: int):
    from deepim_tpu_torch.config import config_from_dict

    return config_from_dict({
        "network": {"input_height": H, "input_width": W, "dtype": "float32", "fc_dim": 64},
        "dataset": {"image_height": H, "image_width": W, "objects": ["box", "icosphere"],
                    "num_points": 64},
        "train": {"batch_size": 2 * n, "warmup_steps": 0},
    })


def run(dev: torch.device, n: int) -> list[str]:
    """The three parts on this rank -> the lines rank 0 prints (every
    rank returns its own)."""
    import torch.distributed as dist

    from deepim_tpu_torch.data import synthetic_batch
    from deepim_tpu_torch.data.pairs import perturb_poses, sample_poses_in_frustum
    from deepim_tpu_torch.parallel import make_mesh, replicate, shard_batch, shard_params_for_tp
    from deepim_tpu_torch.parallel.mesh import gather_rows
    from deepim_tpu_torch.raster.camera import make_intrinsics
    from deepim_tpu_torch.raster.mesh import box_mesh, icosphere_mesh
    from deepim_tpu_torch.refine import build_assets, refine_poses
    from deepim_tpu_torch.train import (
        init_state, make_model, make_synthetic_train_step, make_train_step)

    backend = dist.get_backend()
    cfg = _cfg(n)
    assets = build_assets([box_mesh((0.08, 0.1, 0.06)), icosphere_mesh(0.05)], num_points=64,
                          device=dev)
    k_cam = make_intrinsics(120.0, 120.0, W / 2, H / 2, device=dev)
    lines = []

    base = make_model(cfg, assets.num_classes, generator=torch.Generator().manual_seed(0))

    def model():  # the same initial weights for each part, drawn once
        return copy.deepcopy(base).to(dev)

    # 1. data parallelism over (N, 1)
    mesh = make_mesh(n_data=n)
    state = init_state(cfg, model())
    step = make_synthetic_train_step(state.model, assets, cfg, k_cam, mesh=mesh)
    state, metrics = step(state, torch.Generator(device=dev).manual_seed(1))
    loss = float(metrics["loss"])
    assert state.step == 1 and loss == loss, "DP dry-run step failed"
    lines.append(f"dryrun_multichip({n}) DP: OK loss={loss:.5f} mesh={mesh.shape} "
                 f"backend={backend}")

    # 2. data and tensor parallelism over (N//2, 2)
    if n >= 2:
        mesh2 = make_mesh(n_data=max(n // 2, 1), n_model=2)
        batch = synthetic_batch(torch.Generator(device=dev).manual_seed(2), assets,
                                cfg.train.batch_size, k_cam, (H, W))
        if mesh2.member:
            net = shard_params_for_tp(model(), mesh2)
            state2 = init_state(cfg, net)
            state2, metrics2 = make_train_step(net, assets, cfg, mesh=mesh2)(
                state2, shard_batch(mesh2, batch))
            loss2 = float(metrics2["loss"])
            assert state2.step == 1 and loss2 == loss2, "TP dry-run failed"
            lines.append(f"dryrun_multichip({n}) DP+TP: OK loss={loss2:.5f} "
                         f"mesh={mesh2.shape} fc1={tuple(net.fc1.weight.shape)} "
                         f"backend={backend}")

    # 3. data-parallel evaluation over (N,)
    bs = 2 * n
    net = replicate(mesh, model().eval())
    g = torch.Generator(device=dev).manual_seed(3)
    pose_gt = sample_poses_in_frustum(g, bs, k_cam, (H, W))
    init = perturb_poses(g, pose_gt)
    obs = torch.rand((bs, H, W, 3), generator=g, device=dev)
    cls = torch.zeros((bs,), dtype=torch.long, device=dev)
    ks = k_cam.expand(bs, 3, 3).contiguous()
    rows = shard_batch(mesh, {"obs": obs, "init": init, "ks": ks, "cls": cls})
    with torch.no_grad():
        local = refine_poses(net, assets, rows["obs"], rows["init"], rows["ks"], rows["cls"],
                             num_iters=2, out_size=(H, W))
    k = bs // n
    refined = gather_rows(local, torch.arange(mesh.data_index * k, (mesh.data_index + 1) * k),
                          bs, mesh)
    assert refined.shape == (bs, 3, 4) and bool(torch.isfinite(refined).all()), \
        "eval dry-run non-finite"
    lines.append(f"dryrun_multichip({n}) DP eval: OK batch={bs} mesh={{'data': {n}}} "
                 f"backend={backend}")
    return lines


def main(argv=None) -> int:
    from deepim_tpu_torch.parallel import spawn

    p = argparse.ArgumentParser(description="multi-rank dry run of training and evaluation")
    p.add_argument("n", type=int, nargs="?", default=2, help="ranks (default 2)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the ranks run (default cuda: rank r on cuda:(r %% cards))")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu")
    for line in spawn(run, args.n, args.device, args.n)[0]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
