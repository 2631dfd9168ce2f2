"""The card's idle time inside the program's ``train.step`` root spans but
outside their ``train.synthesis``: the host launching the step's
iterations (render, zoom, forward, losses), backward and optimizer; over
the traced stretch's seconds, in percent (``portbench/spans.py``).
Nothing where the program records no such root."""

from portbench import spans


def read(run):
    got = spans.program_spans()
    if not got:
        return None
    steps = spans.whole_intervals([s for s in got if s.parent is None], {"train.step"})
    synthesis = spans.whole_intervals(got, {"train.synthesis"})
    return spans.idle_share(run, spans.minus(steps, synthesis))
