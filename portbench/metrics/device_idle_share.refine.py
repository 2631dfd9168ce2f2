"""The device's idle share over the traced stretch: 1 less the union of
its kernel and copy intervals over the stretch's length."""

from portbench.trace import idle_share


def read(run):
    return idle_share(run)
