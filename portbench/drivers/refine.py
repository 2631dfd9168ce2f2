"""Offline refinement: back-to-back ``refine_poses`` calls (a closed loop).

Set-up builds the configuration's assets and its inference network, loads
the run's weights, draws a pool of ``pool_batches`` synthetic batches of
``batch`` rows from the seed (``synthetic_batch`` at the configuration's
noise) and warms the call on two of them.  The window calls
``refine_poses`` on the pool's batches in turn, each call ended by the
host reading its poses back, until ``--seconds`` have passed; every call
is counted whole.

``correct``: for ``check_rows_per_batch`` rows of each pool batch, drawn
from the seed, the reference re-derives the row (draws, observed render)
and refines it; every pose the window's calls returned for those rows is
compared with the reference's (``pose_off_share``), and the source poses
with the reference's draws (``draw_gap``).
"""

from __future__ import annotations

import time

import torch

from portbench import common, roofline
from portbench.compare import Check, gap_checks, pose_gaps
from portbench.reference import refine as ref


def _config(ctx):
    cfg = common.program_config(ctx)
    b = ctx.traffic["batch"]
    if cfg.test.batch_size != b:
        cfg = common.replace(cfg, test=common.replace(cfg.test, batch_size=b))
    return cfg


def setup(ctx: common.Ctx) -> dict:
    from deepim_tpu_torch.cli.train import load_assets_and_names
    from deepim_tpu_torch.data.synthetic import synthetic_batch
    from deepim_tpu_torch.train.train import make_model

    dev, tr = ctx.device, ctx.traffic
    cfg = _config(ctx)
    assets, _, _ = load_assets_and_names(cfg, device=dev)
    model = make_model(cfg, assets.num_classes, inference=True).to(dev).eval()
    weights = common.draw_weights(ctx, cfg, decoder=False)
    model.load_state_dict(weights)
    k = common.camera(cfg, dev)
    _, image_size, _ = common.sizes(cfg)
    nz = common.noise(cfg)
    pool = []
    for i in range(tr["pool_batches"]):
        g = torch.Generator(device=dev).manual_seed(common.seed_of(ctx.seed, "pool", i))
        batch = synthetic_batch(g, assets, tr["batch"], k, image_size,
                                rot_noise_deg=nz["rot_deg"], rot_max_deg=nz["rot_max_deg"],
                                trans_noise=tuple(nz["trans"]), trans_max=tuple(nz["trans_max"]))
        pool.append({key: batch[key] for key in ("obs_rgb", "pose_src", "k", "class_idx")})
    state = {"ctx": ctx, "cfg": cfg, "model": model, "assets": assets, "pool": pool,
             "weights": weights, "k": k}
    for i in range(min(2, len(pool))):
        call(state, i).cpu()
    common.sync(dev)
    return state


def call(state: dict, i: int, return_all: bool = False) -> torch.Tensor:
    from deepim_tpu_torch.refine import refine_poses

    cfg, p = state["cfg"], state["pool"][i]
    n = cfg.network
    return refine_poses(state["model"], state["assets"], p["obs_rgb"], p["pose_src"], p["k"],
                        p["class_idx"], num_iters=cfg.test.test_iter,
                        out_size=(n.input_height, n.input_width),
                        coarse_iters=cfg.test.coarse_iters,
                        coarse_size=(n.coarse_height, n.coarse_width) if n.coarse_height else None,
                        return_all=return_all)


def window(state: dict, seconds: float, tracer=None) -> dict:
    n, b = len(state["pool"]), state["ctx"].traffic["batch"]
    outs, calls, first = [], 0, None
    span = tracer.span(seconds) if tracer else None
    common.sync(state["ctx"].device)
    t0 = time.perf_counter()
    while True:
        if span and not tracer.open and not tracer.done and time.perf_counter() - t0 >= span[0]:
            tracer.start()
            first = calls
        outs.append(call(state, calls % n).cpu())
        calls += 1
        if span and tracer.open:
            tracer.calls += 1
            if time.perf_counter() - t0 >= span[1]:
                tracer.stop()
        if time.perf_counter() - t0 >= seconds:
            break
    if span and tracer.open:
        tracer.stop()
    common.sync(state["ctx"].device)
    elapsed = time.perf_counter() - t0
    state["outs"], state["traced"] = outs, (first, tracer.calls if tracer else 0)
    return {"poses": calls * b, "calls": calls, "window_s": elapsed,
            "traced_s": tracer.traced_s if tracer else 0.0,
            "traced_calls": tracer.calls if tracer else 0, "attempted": calls * b, "failed": 0}


def extras(state: dict, counts: dict) -> dict:
    """The least time of the raster launches in the traced stretch: each
    traced call's trajectory is its pool batch's, so each batch is refined
    once more outside the window (``return_all``) and its crops bound."""
    first, traced = state["traced"]
    if first is None or not traced:
        return {}
    cfg, ctx = state["cfg"], state["ctx"]
    objs = common.objects(cfg, ctx.device)
    out_size, _, _ = common.sizes(cfg)
    n = len(state["pool"])
    per_batch = {}
    for i in sorted({c % n for c in range(first, first + traced)}):
        traj = call(state, i, return_all=True)
        p = state["pool"][i]
        per_batch[i] = roofline.refine_render_bound_s(
            objs, p["class_idx"], traj, p["k"], cfg.test.test_iter, cfg.test.coarse_iters, out_size)
    return {"raster_bound_s": sum(per_batch[c % n] for c in range(first, first + traced)),
            "raster_launches": traced * cfg.test.test_iter}


def check(state: dict) -> list[Check]:
    ctx, cfg = state["ctx"], state["cfg"]
    dev, tr = ctx.device, ctx.traffic
    out_size, image_size, grid = common.sizes(cfg)
    pool_src = [p["pose_src"] for p in state["pool"]]
    outs, weights, k = state["outs"], state["weights"], state["k"]
    for key in ("model", "assets", "pool"):
        state.pop(key, None)
    common.free()
    common.float32_exact()
    objs = common.objects(cfg, dev)
    g = torch.Generator().manual_seed(common.seed_of(ctx.seed, "check"))
    b, n = tr["batch"], len(pool_src)
    gaps, draw_gap = [], 0.0
    for i in range(n):
        rows = torch.randperm(b, generator=g)[:tr["check_rows_per_batch"]].sort().values
        want = ref.synthetic_rows(objs, common.seed_of(ctx.seed, "pool", i), dev, b, k,
                                  image_size, common.noise(cfg), rows.tolist())
        draw_gap = max(draw_gap, float((want["pose_src"] - pool_src[i][rows.to(dev)]).abs().max()))
        final = torch.cat([
            ref.refine(weights, objs, want["obs_rgb"][r:r + 16], want["pose_src"][r:r + 16],
                       want["k"][r:r + 16], want["class_idx"][r:r + 16], cfg.test.test_iter,
                       cfg.test.coarse_iters, out_size, grid)
            for r in range(0, len(rows), 16)])
        cls = want["class_idx"]
        for c in range(i, len(outs), n):
            got = outs[c][rows].to(dev)
            gaps.append(pose_gaps(objs.points[cls], objs.diameters[cls], got, final))
    return gap_checks(state, torch.cat(gaps), {"draw_gap": draw_gap}, ctx.limits,
                      ctx.compare["pose_off_at"])
