"""The readings that the limits of ``correct`` are set from, on the chip.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9]
        [--fault-seeds 4,5,6 --fault class|slot|all] [--seconds 3] [--rates 20,30,...]

In one process (one build, one import), for each of ``--seeds`` it makes a
whole run of the cell (set-up, a window of ``--seconds``, the reference's
check) and prints the numbers compared; for each of ``--control-seeds`` it
reads the control: the program's int8 path in place of its bfloat16 one
(refinement and serving), or, for training, the reference itself computed
with int8 and with fp8 operands and gradients, and the reference training
on half of each batch (the mean taken over the rest), each against the
float32 reference; for each of ``--fault-seeds`` a whole run with
``--fault`` planted in the program (``faults.py``).  A run of
the program whose state is returned unchanged reads 1 by the change's
measure and needs no run.  ``--rates`` sweeps a serving cell's arrival rate
on one service: for each rate, a window and its latencies, with the mean
latency of the last third of the requests against the first third (a
backlog that grows shows as a ratio well above 1).

Not run by the benchmark's own runs; its output is what PERF.md's limits
cite.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import common, faults, run, spec  # noqa: E402
from portbench.compare import leaf_gaps, moving_leaves, worst_and_median  # noqa: E402
from portbench.reference import refine as ref  # noqa: E402


def say(**fields):
    print(json.dumps(fields), flush=True)


def program_runs(cell: str, seeds, seconds: float, control=None, device=None, overrides=None,
                 fault=None):
    device = device or torch.device("cuda", 0)
    for s in seeds:
        args = run.parse(["--workload", cell, "--seed", str(s), "--seconds", str(seconds)]
                         + (["--control", control] if control else []))
        t = time.perf_counter()
        with faults.plant(fault) if fault else contextlib.nullcontext():
            res = run.execute(args, device, overrides)
        say(cell=cell, seed=s, control=control, fault=fault, correct=res["correct"],
            checks=res["checks"], metrics=res["metrics"], seconds=time.perf_counter() - t)


def train_controls(cell: str, seeds, device=None, overrides=None):
    """The int8 reference and the half-batch reference against the float32 one."""
    device = device or torch.device("cuda", 0)
    c = spec.workload(cell)
    conf = run._merge(spec.config(c["config"]), (overrides or {}).get("config", {}))
    traffic = spec.traffic(c["traffic"])
    common.float32_exact()
    for s in seeds:
        ctx = common.Ctx(cell, conf, traffic, {}, s, device)
        cfg = common.program_config(ctx)
        out_size, image_size, grid = common.sizes(cfg)
        objs = common.objects(cfg, device)
        t = cfg.train
        k = common.camera(cfg, device)
        weights = common.draw_weights(ctx, cfg, decoder=True)
        batches = [ref.synthetic_rows(objs, common.seed_of(s, "step", i), device, t.batch_size, k,
                                      image_size, common.noise(cfg))
                   for i in range(traffic["checked_steps"])]
        train = {"train_iter": t.train_iter, "w_pm": t.w_pm, "w_flow": t.w_flow,
                 "w_mask": t.w_mask, "flow_occ_stride": t.flow_occ_stride,
                 "grad_clip": t.grad_clip, "lr": t.lr, "warmup_steps": t.warmup_steps,
                 "lr_decay_steps": list(t.lr_decay_steps), "lr_decay_factor": t.lr_decay_factor,
                 "sym_aware_pm": t.sym_aware_pm}
        results = {}
        for name, quant, half in (("reference", None, False), ("int8", "int8", False),
                                  ("fp8", "fp8", False), ("half_batch", None, True)):
            params = {n: w.clone() for n, w in weights.items()}
            use = [{key: v[: t.batch_size // 2] for key, v in b.items()} for b in batches] if half \
                else batches
            got = ref.train_steps(params, objs, use, train, out_size, grid, quant=quant)
            results[name] = {
                "loss": got["loss"],
                "grad": {n: float(g.norm()) for n, g in got["grad"].items()},
                "change": {n: float((params[n] - weights[n]).norm()) for n in params}}
            common.free()
        base = results["reference"]
        keep = moving_leaves(base["grad"])
        for name in ("int8", "fp8", "half_batch"):
            r = results[name]
            grad = worst_and_median(leaf_gaps(r["grad"], base["grad"]))
            change = worst_and_median(leaf_gaps(r["change"], base["change"], keep))
            say(cell=cell, seed=s, control=name,
                loss_gap=max(abs(a - b) / abs(b) for a, b in zip(r["loss"], base["loss"])),
                grad_gap=grad[0], grad_gap_median=grad[1], grad_leaf=grad[2],
                change_gap=change[0], change_gap_median=change[1], change_leaf=change[2],
                left_out=sorted(set(base["grad"]) - keep))


def sweep(cell: str, rates, seconds: float, seed: int, device=None, overrides=None):
    """Arrival rates on one service: p50, p95, and the backlog's trend."""
    device = device or torch.device("cuda", 0)
    c = spec.workload(cell)
    conf = run._merge(spec.config(c["config"]), (overrides or {}).get("config", {}))
    traffic = run._merge(spec.traffic(c["traffic"]), (overrides or {}).get("traffic", {}))
    ctx = common.Ctx(cell, conf, traffic, {}, seed, device)
    driver = spec.driver(traffic["driver"])
    state = driver.setup(ctx)
    for rate in rates:
        ctx.traffic["rate_per_s"] = rate
        counts = driver.window(state, seconds)
        lat = np.asarray(counts["latencies_s"])
        third = max(len(lat) // 3, 1)
        s = counts["stats"]
        say(cell=cell, rate_per_s=rate, requests=counts["requests"], poses=counts["poses"],
            poses_per_s_offered=counts["poses"] / seconds, failed=counts["failed"],
            p50_ms=float(np.percentile(lat, 50) * 1e3), p95_ms=float(np.percentile(lat, 95) * 1e3),
            backlog_trend=float(lat[-third:].mean() / lat[:third].mean()),
            batches=s["device_batches"], padded=s["padded_slots"],
            host_share=s["host_seconds"] / max(s["host_seconds"] + s["refine_seconds"], 1e-9),
            late_p99_ms=float(np.percentile(counts["late_s"], 99) * 1e3))
    state["svc"].close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--rates", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--fault", choices=faults.FAULTS, default="all")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    kind = spec.traffic(spec.workload(args.workload)["traffic"])["driver"]
    say(card=torch.cuda.get_device_name(0), setup_s=time.perf_counter() - T_START)
    if args.rates:
        sweep(args.workload, [float(r) for r in args.rates.split(",")], args.seconds,
              seeds[0] if seeds else 1)
        return 0
    if seeds:
        program_runs(args.workload, seeds, args.seconds)
    if controls and kind == "train":
        train_controls(args.workload, controls)
    elif controls:
        program_runs(args.workload, controls, args.seconds, control="int8")
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    if fault_seeds:
        program_runs(args.workload, fault_seeds, args.seconds, fault=args.fault)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
