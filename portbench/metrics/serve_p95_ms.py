"""The 95th percentile (nearest rank) of every request due in the window,
each timed from when it was due; a failed request counts as the window's
close plus the grace the run waits."""

import math


def read(run):
    lat = run.counts.get("latencies_s")
    if not lat:
        return None
    ordered = sorted(lat)
    return 1e3 * ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]
