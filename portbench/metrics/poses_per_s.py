"""Poses refined in the window over the window's seconds (host clock;
every call synchronised and counted whole)."""


def read(run):
    c = run.counts
    if "poses" not in c or "calls" not in c:
        return None
    return c["poses"] / c["window_s"]
