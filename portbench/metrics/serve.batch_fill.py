"""Useful slots over slots computed in the window's device batches: 1 less
the padded slots over device batches times the batch (``ServiceStats``)."""


def read(run):
    s = run.counts.get("stats")
    if not s or s["device_batches"] <= 0:
        return None
    return 100.0 * (1.0 - s["padded_slots"] / (s["device_batches"] * s["batch"]))
