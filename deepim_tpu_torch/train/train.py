"""Training: the network, the loss assembly, the optimizer and the train steps.

Port of ``deepim_tpu/train/train.py`` (``make_model``, ``make_lr_schedule``,
``make_optimizer``, ``init_state``, ``compute_losses``, ``make_train_step``,
``make_synthetic_train_step``).  With ``mesh=`` (``parallel/mesh.py``) a
step runs on every rank of a process group, where the reference's runs as
a ``shard_map`` over its chips: each rank trains on its rows, then one
all-reduce takes the mean of the gradients and of the metrics before the
optimizer clips (the reference's ``pmean`` precedes optax's clip; a mean
after the clip would clip each rank's own norm).

- The state is a :class:`TrainState` (step, model, optimizer) that the
  steps update in place, where the reference returns a new one.
- The whole synthetic sample pipeline (GT and source poses, the observed
  render, zoom, flow GT) runs on the device inside the fused step, as in
  the reference; renders stay under ``no_grad``: the gradient is taken
  with respect to the parameters only.
- The optimizer is optax's chain in torch terms: ``clip_by_global_norm``
  (scaled by max/norm only when norm >= max, no epsilon: written here,
  not ``clip_grad_norm_``), ``add_decayed_weights`` before the moment
  update (torch ``Adam``'s and ``SGD``'s ``weight_decay``, not ``AdamW``),
  ``scale_by_adam`` or ``trace`` (SGD momentum, dampening 0), then the
  schedule read at the update count before it increments (the first
  warmup update runs at lr 0).
- Metrics stay 0-d tensors on the device: nothing syncs with the host
  until a caller reads them.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import torch

from deepim_tpu_torch.geometry.delta_pose import DeltaPose, apply_delta, calc_delta
from deepim_tpu_torch.geometry.pose_errors import add_error, rot_error_deg, trans_error
from deepim_tpu_torch.losses.losses import (
    angle_trans_l1_loss,
    flow_epe_loss,
    mask_ce_loss,
    point_matching_loss,
)
from deepim_tpu_torch.models.flownet import (
    DeepIMFlowNet,
    bottleneck_grid,
    decode_rot,
    select_class,
)
from deepim_tpu_torch.ops.flow_gt import calc_flow
from deepim_tpu_torch.ops.zoom import zoom_image_batch
from deepim_tpu_torch.parallel.mesh import (
    DATA_AXIS, global_grad_norm, mean_gradients, mean_metrics, sharded_parameters)
from deepim_tpu_torch.refine.refiner import RenderAssets, build_network_inputs, gather_class
from deepim_tpu_torch.utils.profiling import stage


@dataclasses.dataclass
class TrainState:
    """The reference's (step, params, opt_state): ``step`` counts applied
    updates, the parameters live in ``model``, the moments in
    ``optimizer``."""

    step: int
    model: DeepIMFlowNet
    optimizer: torch.optim.Optimizer


def make_model(cfg, num_classes: int, inference: bool = False,
               generator: torch.Generator | None = None) -> DeepIMFlowNet:
    """The network of ``cfg.network`` on the CPU, its initial weights drawn
    from ``generator`` (flax's initialisers; identity pose heads).

    Training models carry the flow decoder and mask head of
    ``network.with_flow``/``with_mask`` (``refine_step`` runs any model
    pose only, as the reference's refine does); ``inference=True`` builds
    the pose-only network the service loads and applies
    ``network.quant``: both ``int8`` and ``int8_static`` build the dynamic
    int8 model (the calibrating entry points, ``cli.test`` and the
    service, turn it into the static one with ``models/quant.py
    §calibrate_model``); training always builds ``"none"``, since
    rounding has no gradient.  The decoder's weights are drawn
    after all others, so both builds share every other initial weight.
    The flatten head is pinned to the full-resolution bottleneck grid
    (``head_grid``), so one set of weights also serves the coarse
    iterations.  A ``class_agnostic`` network has one head for all
    classes.
    """
    n = cfg.network
    return DeepIMFlowNet(
        num_classes=1 if n.class_agnostic else num_classes,
        rot_type=n.rot_type,
        head_grid=bottleneck_grid(n.input_height, n.input_width),
        input_mask=n.input_mask,
        input_depth=n.input_depth,
        fc_dim=n.fc_dim,
        dtype=torch.bfloat16 if n.dtype == "bfloat16" else torch.float32,
        quant="int8" if inference and n.quant.startswith("int8") else "none",
        with_flow=n.with_flow and not inference,
        with_mask=n.with_mask and not inference,
        pose_head=n.pose_head,
        mxnet_pad=n.mxnet_pad,
        generator=generator,
    )


def make_lr_schedule(cfg) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0-based), as optax's: a
    linear warmup from 0 over ``warmup_steps`` joined to a piecewise
    constant decay whose boundaries count from the end of the warmup and
    switch at ``count >= boundary``."""
    t = cfg.train
    bounds = sorted({int(s) for s in t.lr_decay_steps})

    def decay(count: int) -> float:
        v = t.lr
        for b in bounds:
            if count >= b:
                v = v * t.lr_decay_factor
        return v

    if t.warmup_steps <= 0:
        return decay

    def schedule(count: int) -> float:
        if count < t.warmup_steps:
            frac = 1.0 - min(max(count, 0), t.warmup_steps) / t.warmup_steps
            return (0.0 - t.lr) * frac + t.lr
        return decay(count - t.warmup_steps)

    return schedule


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    """SGD with momentum (the reference's) or Adam over ``params``, with
    ``train.weight_decay`` added to the gradient before the moments (optax
    ``add_decayed_weights``).  The learning rate is set before each update
    from :func:`make_lr_schedule`; the clip is :func:`clip_by_global_norm`."""
    t = cfg.train
    if t.optimizer == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=t.momentum, dampening=0.0,
                               weight_decay=t.weight_decay, nesterov=False)
    if t.optimizer == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=t.weight_decay)
    raise ValueError(t.optimizer)


def init_state(cfg, model: DeepIMFlowNet) -> TrainState:
    """Step 0, the optimizer over ``model``'s parameters, and a zero gradient
    for every parameter: a parameter no loss reaches still takes its
    update (weight decay, moments), as it does in optax."""
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    return TrainState(0, model, make_optimizer(cfg, model.parameters()))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / norm where norm >= max_norm
    (optax's rule, no epsilon, no host sync) -> the unclipped norm
    (``global_norm(grads)`` unless given)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def apply_gradients(state: TrainState, cfg, schedule: Callable[[int], float],
                    mesh=None) -> torch.Tensor:
    """One optimizer update from the parameters' ``.grad`` -> the unclipped
    gradient norm (the whole model's under a tensor-parallel ``mesh``)."""
    grads = [p.grad for g in state.optimizer.param_groups for p in g["params"]]
    norm = None
    if mesh is not None and sharded_parameters(state.model):
        norm = global_grad_norm(state.model, mesh)
    norm = clip_by_global_norm(grads, cfg.train.grad_clip, norm)
    lr = schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return norm


def compute_losses(model: DeepIMFlowNet, assets: RenderAssets,
                   batch: dict[str, torch.Tensor], cfg
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Forward and every loss of one (possibly iterative) training step ->
    (total, metrics).

    ``batch``: obs_rgb (B, H, W, 3), obs_depth (B, H, W), obs_mask (B, H, W),
    pose_src/pose_tgt (B, 3, 4), k (B, 3, 3), class_idx (B,).  Metrics:
    ``pm_loss_{it}`` (or ``rot_loss_{it}``/``trans_loss_{it}``),
    ``flow_loss_{it}``, ``mask_loss_{it}``, ``rot_err_deg_{it}``,
    ``trans_err_{it}``, ``add_{it}`` and ``loss``, detached.  Spans: a
    ``train.iter`` (it) an iteration, holding the refine loop's input spans
    (``build_network_inputs``), ``network.forward`` and ``train.losses``.
    """
    t = cfg.train
    out_size = (cfg.network.input_height, cfg.network.input_width)
    ab = gather_class(assets, batch["class_idx"])
    pose_tgt, pose_src = batch["pose_tgt"], batch["pose_src"]
    total = 0.0
    metrics: dict[str, torch.Tensor] = {}
    for it in range(t.train_iter):
        with stage("train.iter", it=it):
            # The refine loop's own input assembly (under no_grad): the network
            # trains on the distribution it refines with.
            ni = build_network_inputs(model, ab, batch["obs_rgb"], pose_src, batch["k"],
                                      out_size, obs_mask=batch["obs_mask"],
                                      obs_depth=batch["obs_depth"])
            with stage("network.forward"):
                out = model(ni.x)
            kz = ni.k_zoom
            with stage("train.losses"):
                quat = decode_rot(select_class(out["rot_raw"], batch["class_idx"]), model.rot_type)
                delta = DeltaPose(quat, select_class(out["trans"], batch["class_idx"]))

                if t.pose_loss == "separate":
                    rot_l, trans_l = angle_trans_l1_loss(delta, calc_delta(pose_src, pose_tgt, kz))
                    loss_it = t.w_rot * rot_l.mean() + t.w_trans * trans_l.mean()
                    metrics[f"rot_loss_{it}"] = rot_l.mean().detach()
                    metrics[f"trans_loss_{it}"] = trans_l.mean().detach()
                else:
                    pm = point_matching_loss(
                        ab.points, delta, pose_src, pose_tgt, kz,
                        sym_poses=ab.sym_poses if t.sym_aware_pm else None,
                        sym_continuous=ab.sym_continuous if t.sym_aware_pm else None)
                    loss_it = t.w_pm * pm.mean()
                    metrics[f"pm_loss_{it}"] = pm.mean().detach()

                if model.with_flow and t.w_flow > 0:
                    with torch.no_grad():
                        obs_depth_crop = zoom_image_batch(batch["obs_depth"][..., None], ni.box,
                                                          out_size, "nearest")[..., 0]
                        flow_gt, valid = calc_flow(ni.ren_depth, pose_src, pose_tgt, kz,
                                                   obs_depth_crop,
                                                   occlusion_stride=t.flow_occ_stride)
                    fl = flow_epe_loss(out["flow"], flow_gt, valid)
                    loss_it = loss_it + t.w_flow * fl.mean()
                    metrics[f"flow_loss_{it}"] = fl.mean().detach()

                if model.with_mask and t.w_mask > 0:
                    with torch.no_grad():
                        obs_mask_crop = zoom_image_batch(
                            batch["obs_mask"][..., None].to(torch.float32), ni.box, out_size,
                            "nearest")[..., 0]
                    ml = mask_ce_loss(out["mask_logit"], obs_mask_crop)
                    loss_it = loss_it + t.w_mask * ml.mean()
                    metrics[f"mask_loss_{it}"] = ml.mean().detach()

                # Pose-accuracy monitors; the next iteration refines from the
                # updated pose (in the batch's dtype), with the gradient stopped there.
                pose_new = apply_delta(pose_src, delta, kz).detach().to(pose_src.dtype)
                metrics[f"rot_err_deg_{it}"] = rot_error_deg(pose_new, pose_tgt).mean()
                metrics[f"trans_err_{it}"] = trans_error(pose_new, pose_tgt).mean()
                metrics[f"add_{it}"] = add_error(ab.points, pose_new, pose_tgt).mean()
            total = total + loss_it
            pose_src = pose_new
    metrics["loss"] = total.detach()
    return total, metrics


def _train_on(state: TrainState, assets: RenderAssets, batch, cfg, schedule, mesh=None):
    """Spans: ``train.backward``, ``train.optimizer`` (clip and update)."""
    state.optimizer.zero_grad(set_to_none=False)
    loss, metrics = compute_losses(state.model, assets, batch, cfg)
    with stage("train.backward"):
        loss.backward()
    if mesh is not None:
        mean_gradients(state.model, mesh)
        metrics = mean_metrics(metrics, mesh)
    with stage("train.optimizer"):
        metrics["grad_norm"] = apply_gradients(state, cfg, schedule, mesh)
    return state, metrics


def make_train_step(model: DeepIMFlowNet, assets: RenderAssets, cfg, mesh=None):
    """The train step on a given batch: (state, batch) -> (state, metrics),
    ``state`` updated in place.  ``model`` is the state's model.

    With ``mesh`` the step runs on every rank of it: ``batch`` is this
    rank's rows (``parallel.shard_batch`` of the global batch, or a
    rank-sharded loader's), and the gradients and metrics are the mean over
    the mesh's data ranks.
    """
    schedule = make_lr_schedule(cfg)

    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        if state.model is not model:
            raise ValueError("the step was built for another model")
        with stage("train.step"):
            return _train_on(state, assets, batch, cfg, schedule, mesh)

    return step


def rank_generator(generator: torch.Generator, data_index: int) -> torch.Generator:
    """A generator of its own for data rank ``data_index`` (the
    reference's ``fold_in`` of the shard index): seeded from a hash of
    ``generator``'s state and the index, read on the host.  ``generator``
    then takes one draw, so a caller that does not reseed gets new
    batches at its next step."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()
                            + data_index.to_bytes(4, "little")).digest()
    local = torch.Generator(device=generator.device)
    local.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    torch.randint(2, (1,), generator=generator, device=generator.device)
    return local


def make_synthetic_train_step(model: DeepIMFlowNet, assets: RenderAssets, cfg,
                              k_cam: torch.Tensor, mesh=None):
    """The fused synthesize-and-train step: (state, generator) -> (state,
    metrics), the batch drawn on the device from ``generator`` (on the
    assets' device) and never seen by the host.

    With ``mesh`` every rank draws ``batch_size / n_data`` samples, from
    :func:`rank_generator` when there are several data ranks (with one,
    from ``generator`` itself: the draws of the step without a mesh), and
    the gradients and metrics are the mean over the data ranks.
    ``dataset.name == "synthetic_occlusion"`` switches the generator to
    multi-object occlusion scenes (the Occluded-LINEMOD protocol).
    """
    from deepim_tpu_torch.data.synthetic import synthetic_batch, synthetic_occlusion_batch

    t = cfg.train
    image_size = (cfg.dataset.image_height, cfg.dataset.image_width)
    gen = (synthetic_occlusion_batch if cfg.dataset.name == "synthetic_occlusion"
           else synthetic_batch)
    schedule = make_lr_schedule(cfg)
    n_data = 1 if mesh is None else mesh.shape[DATA_AXIS]
    local_bs = t.batch_size // n_data
    if local_bs * n_data != t.batch_size:
        raise ValueError(f"batch {t.batch_size} must divide the mesh's {n_data} data ranks")

    def step(state: TrainState, generator: torch.Generator):
        if state.model is not model:
            raise ValueError("the step was built for another model")
        with stage("train.step"):
            with stage("train.synthesis"):
                if n_data > 1:
                    generator = rank_generator(generator, mesh.data_index)
                batch = gen(generator, assets, local_bs, k_cam, image_size,
                            rot_noise_deg=t.rot_noise_deg, rot_max_deg=t.rot_noise_max_deg,
                            trans_noise=t.trans_noise, trans_max=t.trans_noise_max)
                batch.pop("visible_frac", None)
            return _train_on(state, assets, batch, cfg, schedule, mesh)

    return step
