"""The pose service under open-loop arrivals.

Set-up starts ``PoseRefinerService`` at the configuration's device batch
and ``gather_window_s``, loads the run's weights into its model, draws a
host pool of ``pool_rows`` synthetic rows from the seed (frames, source
poses, intrinsics, classes, as numpy) and warms the service with a few
requests.

Arrivals are Poisson at ``rate_per_s`` requests a second, each asking for
``n`` objects, ``n`` uniform in ``objects_per_request``.  The gaps and the
sizes are one fixed sequence, drawn once from ``arrival_seed``, that every
run sends from another starting point (a rotation by its seed), so runs
differ in order and not in work, and keep the sequence's bursts (a
shuffle made a new burst pattern a seed, and the 95th percentile swung
with it).  A request takes ``n`` consecutive rows of the pool (a view, no
copy on the client side).  One dispatcher sends each request when it is
due to one of ``clients`` client threads, which call ``refine`` and
record when it returned.  A request's latency runs from when it was due,
so a stall also delays the requests queued behind it; one that failed or
never returned within ``grace_s`` of the window's close counts as the
close plus ``grace_s``.

A traced run profiles the whole window: the profiler starts before the
first request and stops once the last has returned, both with the service
idle (stopping it while the worker thread launched work crashed a run).

``correct``: ``check_rows`` pool rows drawn from the seed are refined by
the reference; every pose the service returned for one of them is compared
(``pose_off_share``), and the source poses with the reference's draws
(``draw_gap``).  A request that failed or never returned makes the run
incorrect.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import common
from portbench.compare import gap_checks, pose_gaps
from portbench.reference import refine as ref

WARM_REQUESTS = 4


def schedule(tr: dict, seconds: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(due times in seconds from the window's start, objects a request)."""
    fixed = np.random.RandomState(tr["arrival_seed"])
    gaps = fixed.exponential(1.0 / tr["rate_per_s"], size=int(tr["rate_per_s"] * seconds * 2) + 16)
    count = int(np.searchsorted(np.cumsum(gaps), seconds))
    lo, hi = tr["objects_per_request"]
    sizes = fixed.randint(lo, hi + 1, size=count)
    shift = common.seed_of(seed, "arrivals") % max(count, 1)
    return np.cumsum(np.roll(gaps[:count], shift)), np.roll(sizes, shift)


def setup(ctx: common.Ctx) -> dict:
    from deepim_tpu_torch.data.synthetic import synthetic_batch
    from deepim_tpu_torch.serve import PoseRefinerService

    dev, tr = ctx.device, ctx.traffic
    cfg = common.program_config(ctx)
    svc = PoseRefinerService(cfg, load_checkpoint=False, gather_window_s=tr["gather_window_s"],
                             device=dev)
    weights = common.draw_weights(ctx, cfg, decoder=False)
    svc.model.load_state_dict(weights)
    k = common.camera(cfg, dev)
    _, image_size, _ = common.sizes(cfg)
    nz = common.noise(cfg)
    parts, srcs = [], []
    per = tr["pool_batch"]
    for i in range(tr["pool_rows"] // per):
        g = torch.Generator(device=dev).manual_seed(common.seed_of(ctx.seed, "pool", i))
        batch = synthetic_batch(g, svc.assets, per, k, image_size,
                                rot_noise_deg=nz["rot_deg"], rot_max_deg=nz["rot_max_deg"],
                                trans_noise=tuple(nz["trans"]), trans_max=tuple(nz["trans_max"]))
        parts.append({key: batch[key].cpu().numpy()
                      for key in ("obs_rgb", "pose_src", "k", "class_idx")})
        srcs.append(batch["pose_src"])
    pool = {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}
    state = {"ctx": ctx, "cfg": cfg, "svc": svc, "pool": pool, "pool_src": srcs,
             "weights": weights, "k": k}
    hi = tr["objects_per_request"][1]
    for j in range(WARM_REQUESTS):
        rows = slice(j * hi, (j + 1) * hi)
        svc.refine(*(pool[key][rows] for key in ("obs_rgb", "pose_src", "k", "class_idx")))
    common.sync(dev)
    return state


def window(state: dict, seconds: float, tracer=None) -> dict:
    ctx, svc, pool = state["ctx"], state["svc"], state["pool"]
    tr = ctx.traffic
    due, sizes = schedule(tr, seconds, ctx.seed)
    n_rows = pool["obs_rgb"].shape[0]
    starts, cursor = [], 0
    for n in sizes:
        cursor = 0 if cursor + n > n_rows else cursor
        starts.append(cursor)
        cursor += int(n)
    done = [None] * len(due)
    results = [None] * len(due)
    late = np.zeros(len(due))

    def client(j):
        rows = slice(starts[j], starts[j] + int(sizes[j]))
        try:
            results[j] = svc.refine(*(pool[key][rows]
                                      for key in ("obs_rgb", "pose_src", "k", "class_idx")))
        except Exception as e:  # counted as failed
            results[j] = e
        done[j] = time.perf_counter()

    before = _stats(svc)
    if tracer:  # the whole window, opened and closed with the service idle
        tracer.launcher = next(t.ident for t in threading.enumerate()
                               if "_worker_loop" in t.name)
        tracer.start()
    pool_exec = ThreadPoolExecutor(max_workers=tr["clients"])
    t0 = time.perf_counter()
    futures = []
    for j, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[j] = time.perf_counter() - (t0 + d)
        futures.append(pool_exec.submit(client, j))
    time.sleep(max(t0 + seconds - time.perf_counter(), 0.0))
    after = _stats(svc)
    deadline = t0 + seconds + tr["grace_s"]
    for f in futures:
        try:
            f.result(timeout=max(deadline - time.perf_counter(), 0.0))
        except TimeoutError:
            break  # the rest count as failed; close() in check releases their clients
    pool_exec.shutdown(wait=False)
    if tracer:
        tracer.stop()
    cap = seconds + tr["grace_s"]
    lat, failed = [], 0
    for j, d in enumerate(due):
        bad = done[j] is None or isinstance(results[j], Exception)
        failed += bad
        lat.append(cap if bad else done[j] - (t0 + d))
    print(f"generator: {len(due)} requests, {int(sizes.sum())} poses, late by "
          f"median {np.median(late) * 1e3:.3f} ms, p99 {np.percentile(late, 99) * 1e3:.3f} ms, "
          f"max {late.max() * 1e3:.3f} ms", file=sys.stderr, flush=True)
    state.update(starts=starts, sizes=sizes, results=results, failed=failed)
    stats = {k: after[k] - before[k] for k in after if k != "batch"}
    stats["batch"] = svc.batch
    _describe(np.asarray(lat) * 1e3, due, seconds, stats)
    return {"latencies_s": lat, "requests": len(due), "poses": int(sizes.sum()),
            "window_s": seconds, "attempted": len(due), "failed": failed, "stats": stats,
            "late_s": late.tolist()}


def _describe(lat_ms: np.ndarray, due: np.ndarray, seconds: float, stats: dict) -> None:
    """Latency quantiles, the 95th percentile of each fifth of the window by
    due time, and the worker's mean time a device batch (stderr only)."""
    q = np.percentile(lat_ms, [50, 90, 95, 99])
    fifths = [np.percentile(lat_ms[(due >= seconds * i / 5) & (due < seconds * (i + 1) / 5)], 95)
              for i in range(5)]
    nb = max(stats["device_batches"], 1)
    print(f"latency: mean {lat_ms.mean():.2f} p50 {q[0]:.2f} p90 {q[1]:.2f} p95 {q[2]:.2f} "
          f"p99 {q[3]:.2f} max {lat_ms.max():.2f} ms; p95 by fifth "
          f"{' '.join(f'{v:.1f}' for v in fifths)} ms; {stats['device_batches']} batches, "
          f"host {1e3 * stats['host_seconds'] / nb:.2f} refine {1e3 * stats['refine_seconds'] / nb:.2f}"
          f" ms a batch, fill {stats['poses'] / (nb * stats['batch']):.3f}",
          file=sys.stderr, flush=True)


def _stats(svc) -> dict:
    s = svc.stats
    with s.lock:
        return {"poses": s.poses, "requests": s.requests, "device_batches": s.device_batches,
                "padded_slots": s.padded_slots, "host_seconds": s.host_seconds,
                "refine_seconds": s.refine_seconds, "batch": svc.batch}


def extras(state: dict, counts: dict) -> dict:
    return {}


def check(state: dict) -> list[Check]:
    ctx, cfg = state["ctx"], state["cfg"]
    dev, tr = ctx.device, ctx.traffic
    out_size, image_size, grid = common.sizes(cfg)
    state["svc"].close()
    per = tr["pool_batch"]
    starts, sizes, results = state["starts"], state["sizes"], state["results"]
    src, weights, k = state["pool_src"], state["weights"], state["k"]
    for key in ("svc", "pool"):
        state.pop(key, None)
    common.free()
    common.float32_exact()
    objs = common.objects(cfg, dev)
    g = torch.Generator().manual_seed(common.seed_of(ctx.seed, "check"))
    picked = torch.randperm(tr["pool_rows"], generator=g)[:tr["check_rows"]].sort().values.tolist()
    want_final, draw_gap = {}, 0.0
    for i in range(tr["pool_rows"] // per):
        rows = [r - i * per for r in picked if i * per <= r < (i + 1) * per]
        if not rows:
            continue
        want = ref.synthetic_rows(objs, common.seed_of(ctx.seed, "pool", i), dev, per, k,
                                  image_size, common.noise(cfg), rows)
        draw_gap = max(draw_gap, float((want["pose_src"] - src[i][rows]).abs().max()))
        for r0 in range(0, len(rows), 16):
            sl = slice(r0, r0 + 16)
            final = ref.refine(weights, objs, want["obs_rgb"][sl], want["pose_src"][sl],
                               want["k"][sl], want["class_idx"][sl], cfg.test.test_iter,
                               cfg.test.coarse_iters, out_size, grid)
            for r, pose, c in zip(rows[sl], final, want["class_idx"][sl]):
                want_final[i * per + r] = (pose, int(c))
    gaps = []
    for j, res in enumerate(results):
        if res is None or isinstance(res, Exception):
            continue
        for r in range(starts[j], starts[j] + int(sizes[j])):
            if r in want_final:
                pose, c = want_final[r]
                got = torch.as_tensor(res[r - starts[j]], device=dev)[None]
                gaps.append(pose_gaps(objs.points[c][None], objs.diameters[c][None], got,
                                      pose[None]))
    return gap_checks(state, torch.cat(gaps), {"draw_gap": draw_gap,
                                                "failed_requests": float(state["failed"])},
                      ctx.limits, ctx.compare["pose_off_at"])
