"""The refine loop's share of the card's bf16 dense peak: forward FLOPs of
every pose refined in the window (the network's layer shapes, K
iterations, the coarse ones at half size) over the window's seconds.  In
a traced run only the calls outside the traced stretch count, over the
window's seconds outside it, so the profiler's own cost is left out."""

from portbench import flops, roofline
from portbench.reference.network import grid


def read(run):
    c = run.counts
    if "poses" not in c or not c.get("calls"):
        return None
    exp = run.config["experiment"]
    net, test = exp.get("network", {}), exp["test"]
    size = (net.get("input_height", 480), net.get("input_width", 640))
    coarse = (net.get("coarse_height") or size[0] // 2, net.get("coarse_width") or size[1] // 2)
    per_pose = flops.refine_flops(size, coarse, test["test_iter"], test.get("coarse_iters", 0),
                                  grid(*size), len(exp["dataset"]["objects"]))
    calls = c["calls"] - c.get("traced_calls", 0)
    seconds = c["window_s"] - c.get("traced_s", 0.0)
    if calls <= 0 or seconds <= 0:
        return None
    poses = c["poses"] * calls / c["calls"]
    return 100.0 * per_pose * poses / seconds / roofline.BF16_FLOPS
