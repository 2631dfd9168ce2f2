"""The card's idle time while the launching thread's innermost open span is
``render.pack`` or ``render.bin`` (the raster front end: plane packing and
binning, the cols route's overflow read included), over the traced
stretch's seconds, in percent (``portbench/spans.py``).  Nothing where the
program records no such span."""

from portbench import spans


def read(run):
    got = spans.program_spans()
    if not got:
        return None
    return spans.idle_share(run, spans.own_intervals(got, {"render.pack", "render.bin"}))
