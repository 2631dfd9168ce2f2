"""The sorted raster kernel's share of its roofline in the traced stretch:
the least time of every crop render there (``roofline.py``, from the
poses each call's iterations started from) over the device time of the
kernels named ``raster_sorted`` in the trace.  Nothing when the launches
in the trace are not the renders bounded."""

from portbench.trace import kernel_seconds


def read(run):
    if not run.trace or "raster_bound_s" not in run.extras:
        return None
    seconds, launches = kernel_seconds(run.trace, "raster_sorted")
    if seconds <= 0 or launches != run.extras["raster_launches"]:
        return None
    return 100.0 * run.extras["raster_bound_s"] / seconds
