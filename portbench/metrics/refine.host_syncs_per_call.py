"""Device-to-host syncs the program counted under its ``refine_poses`` root
spans in the traced stretch, over the number of those roots: a call's
syncs (``portbench/spans.py``).  Nothing where the program records no such
root."""

from portbench import spans


def read(run):
    got = spans.program_spans()
    return spans.syncs_per_root(got, "refine_poses") if got else None
