"""The train step's share of the card's bf16 dense peak: forward and
backward FLOPs of the network (layer shapes, flow and mask heads) per
sample and iteration, times the samples and ``train_iter`` of the window,
over the window's seconds.  In a traced run only the steps outside the
traced stretch count, over the window's seconds outside it, so the
profiler's own cost is left out."""

from portbench import flops, roofline
from portbench.reference.network import grid


def read(run):
    c = run.counts
    if "samples" not in c or not c.get("steps"):
        return None
    exp = run.config["experiment"]
    net, train = exp.get("network", {}), exp["train"]
    size = (net.get("input_height", 480), net.get("input_width", 640))
    per = flops.network_flops(size, grid(*size), net.get("with_flow", True),
                              net.get("with_mask", True), len(exp["dataset"]["objects"]))[1]
    iters = train.get("train_iter", 1)
    steps = c["steps"] - c.get("traced_steps", 0)
    seconds = c["window_s"] - c.get("traced_s", 0.0)
    if steps <= 0 or seconds <= 0:
        return None
    samples = c["samples"] * steps / c["steps"]
    return 100.0 * per * iters * samples / seconds / roofline.BF16_FLOPS
