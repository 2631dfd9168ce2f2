"""Device-to-host syncs the program counted under its ``train.step`` root
spans in the traced stretch, over the number of those roots: a step's
syncs (``portbench/spans.py``).  Nothing where the program records no such
root."""

from portbench import spans


def read(run):
    got = spans.program_spans()
    return spans.syncs_per_root(got, "train.step") if got else None
