"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from this process's start to the first timed call)
builds the program's side of the cell and warms every shape it will use;
the window runs the cell's traffic for ``--seconds``; then the device's
peak memory is read, the program's state is freed, and the reference
decides ``correct``.  With ``--trace 1`` a stretch of the window runs
under the profiler and the cell's per-layer metrics are reported instead
of its end-to-end ones, with ``busy_s``, ``window_s`` and a breakdown.

Exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.  ``--control int8`` runs
the program's int8 path, the control of ``correct`` (``calibrate.py``),
never a cell's run: it prints no result line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CACHE = ROOT / "portbench" / ".cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from portbench import common, compare, spec  # noqa: E402
from portbench.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "deepim_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("int8",), default=None,
                   help="run the program's int8 path, the control of correct (builder only)")
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def execute(args, device: torch.device, overrides: dict | None = None) -> dict:
    """Everything of a run after the look for a chip -> the result dict.
    ``overrides`` deep-merges into the config, traffic and limits (tests)."""
    overrides = overrides or {}
    bench = spec.benchmark()
    cell = work = spec.workload(args.workload)
    conf = _merge(spec.config(cell["config"]), overrides.get("config", {}))
    traffic = _merge(spec.traffic(cell["traffic"]), overrides.get("traffic", {}))
    limits = _merge(work["limits"], overrides.get("limits", {}))
    ctx = common.Ctx(args.workload, conf, traffic, limits, args.seed, device,
                     control=args.control,
                     compare=_merge(work.get("compare", {}), overrides.get("compare", {})))
    driver = spec.driver(traffic["driver"])
    tracer = Tracer(device) if args.trace else None
    state = driver.setup(ctx)
    if tracer:
        tracer.warm()
    setup_s = time.perf_counter() - T_START
    counts = driver.window(state, args.seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    summary = tracer.summary() if tracer and tracer.events is not None else None
    extras = driver.extras(state, counts) if tracer else {}
    checks = driver.check(state)
    run = SimpleNamespace(cell=cell, config=conf, traffic=traffic, seed=args.seed, setup_s=setup_s,
                          counts=counts, trace=summary, extras=extras)
    metrics = {}
    for m in spec.metrics_for(bench, args.workload, bool(args.trace)):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(float(value)), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks), "attempted": counts["attempted"],
              "failed": counts["failed"], "metrics": metrics, "device": dev_info}
    if summary:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit} for c in checks}
    if state.get("readings"):
        print(f"readings {json.dumps(state['readings'])}", file=sys.stderr)
    compare.report(checks)
    return result


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    errs = spec.validate(bench)
    if errs:
        print("BENCHMARK.json refused:\n" + "\n".join(errs), file=sys.stderr)
        return 2
    chips = spec.cell(bench, args.workload)["chips"]  # only cells of BENCHMARK.json run here
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = execute(args, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    if args.control is not None:
        print(f"control run ({args.control}): {json.dumps(result)}")
        return 0
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
