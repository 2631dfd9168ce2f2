"""Samples trained in the window over the window's seconds (host clock;
the device synchronised at the end, every step counted whole)."""


def read(run):
    c = run.counts
    return c["samples"] / c["window_s"] if "samples" in c else None
