"""Training: the fused synthesize-and-train step, back to back.

Set-up builds the configuration's assets, its training network (flow and
mask heads) with the run's weights (the program's own initialisation from
a generator seeded by the run where the configuration's ``weights.init``
says ``program``, else the benchmark's draw), the optimizer state and the
step ``make_synthetic_train_step`` gives, then takes the first
``checked_steps`` steps through that same step (the step's generator
reseeded from the run's seed and the step's number, as the training
driver does, so every step draws other rows).  They warm every shape and
leave what ``correct`` compares: each step's loss, the first clipped
gradient (from Adam's first moment after one step, 0.1 of it) and the
parameters after the last.  The window goes on from there, step after
step, until ``--seconds`` have passed; the device is synchronised once at
the end and every step is counted whole.

``correct``: the reference, from the same weights (worked out again from
the seed), draws and renders the same three batches and takes three steps
of its own (float32, the configuration's losses, clip and Adam with its
learning-rate warm-up);
``loss_gap``, ``grad_gap`` and ``change_gap`` hold the program to it.
"""

from __future__ import annotations

import time

import torch

from portbench import common
from portbench.compare import Check, leaf_gaps, moving_leaves, worst_and_median
from portbench.reference import refine as ref

BETA1 = 0.9


def setup(ctx: common.Ctx) -> dict:
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.train.train import init_state, make_model, make_synthetic_train_step

    dev = ctx.device
    cfg = common.program_config(ctx)
    assets, _, _ = load_assets_and_names(cfg, device=dev)
    model = make_model(cfg, assets.num_classes, generator=common.init_generator(ctx)).to(dev)
    if not common.program_inits(ctx):
        model.load_state_dict(common.draw_weights(ctx, cfg, decoder=True))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = init_state(cfg, model)
    step = make_synthetic_train_step(model, assets, cfg, common.camera(cfg, dev))
    gen = torch.Generator(device=dev)
    run = {"ctx": ctx, "cfg": cfg, "state": state, "step": step, "gen": gen,
           "steps": 0}
    params = dict(model.named_parameters())
    losses = []
    for it in range(ctx.traffic["checked_steps"]):
        _, metrics = take(run)
        losses.append(metrics["loss"])
        if it == 0:
            opt = state.optimizer.state
            run["grad_norms"] = {n: float(opt[p]["exp_avg"].norm()) / (1.0 - BETA1)
                                 if "exp_avg" in opt.get(p, {}) else 0.0
                                 for n, p in params.items()}
    run["change_norms"] = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
    del start
    run["losses"] = [float(v) for v in losses]
    common.sync(dev)
    return run


def take(run: dict):
    seed = common.seed_of(run["ctx"].seed, "step", run["steps"])
    run["steps"] += 1
    return run["step"](run["state"], run["gen"].manual_seed(seed))


def window(run: dict, seconds: float, tracer=None) -> dict:
    steps = 0
    span = tracer.span(seconds) if tracer else None
    dev = run["ctx"].device
    common.sync(dev)
    t0 = time.perf_counter()
    while True:
        if span and not tracer.open and not tracer.done and time.perf_counter() - t0 >= span[0]:
            tracer.start()
        take(run)
        steps += 1
        if span and tracer.open:
            tracer.calls += 1
            if time.perf_counter() - t0 >= span[1]:
                tracer.stop()
        if time.perf_counter() - t0 >= seconds:
            break
    if span and tracer.open:
        tracer.stop()
    common.sync(dev)
    elapsed = time.perf_counter() - t0
    b = run["cfg"].train.batch_size
    return {"samples": steps * b, "steps": steps, "window_s": elapsed,
            "traced_s": tracer.traced_s if tracer else 0.0,
            "traced_steps": tracer.calls if tracer else 0, "attempted": steps * b, "failed": 0}


def extras(run: dict, counts: dict) -> dict:
    return {}


def check(run: dict) -> list[Check]:
    ctx, cfg = run["ctx"], run["cfg"]
    dev = ctx.device
    out_size, image_size, grid = common.sizes(cfg)
    for key in ("state", "step", "gen"):
        run.pop(key, None)
    common.free()
    common.float32_exact()
    objs = common.objects(cfg, dev)
    t = cfg.train
    k = common.camera(cfg, dev)
    batches = [ref.synthetic_rows(objs, common.seed_of(ctx.seed, "step", i), dev, t.batch_size,
                                  k, image_size, common.noise(cfg))
               for i in range(ctx.traffic["checked_steps"])]
    weights = common.draw_weights(ctx, cfg, decoder=True)  # worked out again from the seed
    params = {n: w.clone() for n, w in weights.items()}
    train = {"train_iter": t.train_iter, "w_pm": t.w_pm, "w_flow": t.w_flow, "w_mask": t.w_mask,
             "flow_occ_stride": t.flow_occ_stride, "grad_clip": t.grad_clip, "lr": t.lr,
             "warmup_steps": t.warmup_steps, "lr_decay_steps": list(t.lr_decay_steps),
             "lr_decay_factor": t.lr_decay_factor, "sym_aware_pm": t.sym_aware_pm}
    if t.pose_loss != "pm" or t.optimizer != "adam" or t.weight_decay:
        raise ValueError("the reference trains with the point-matching loss and Adam, no decay")
    got = ref.train_steps(params, objs, batches, train, out_size, grid)
    grad_ref = {n: float(g.norm()) for n, g in got["grad"].items()}
    change_ref = {n: float((params[n] - weights[n]).norm()) for n in params}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(run["losses"], got["loss"]))
    grad, grad_med, grad_leaf = worst_and_median(leaf_gaps(run["grad_norms"], grad_ref))
    change, change_med, change_leaf = worst_and_median(
        leaf_gaps(run["change_norms"], change_ref, moving_leaves(grad_ref)))
    run["readings"] = {"losses": run["losses"], "reference_losses": got["loss"],
                       "grad_leaf": grad_leaf, "change_leaf": change_leaf}
    values = {"loss_gap": loss_gap, "grad_gap": grad, "grad_gap_median": grad_med,
              "change_gap": change, "change_gap_median": change_med}
    return [Check(n, values[n], limit) for n, limit in ctx.limits.items()]
