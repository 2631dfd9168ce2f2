"""The card's idle time inside the program's ``train.synthesis`` spans, their
children (the observed render) included, over the traced stretch's
seconds, in percent (``portbench/spans.py``).  Nothing where the program
records no such span."""

from portbench import spans


def read(run):
    got = spans.program_spans()
    if not got:
        return None
    return spans.idle_share(run, spans.whole_intervals(got, {"train.synthesis"}))
