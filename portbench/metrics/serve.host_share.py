"""The service worker's host share: seconds stacking samples and copying
them to the card over those plus the seconds in ``refine_poses`` and the
copy back, summed over the window's device batches (``ServiceStats``)."""


def read(run):
    s = run.counts.get("stats")
    if not s or s["host_seconds"] + s["refine_seconds"] <= 0:
        return None
    return 100.0 * s["host_seconds"] / (s["host_seconds"] + s["refine_seconds"])
