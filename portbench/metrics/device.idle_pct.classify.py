"""The share of the traced slice in which no kernel, copy or fill ran on
the device, in the classify cells."""

from portbench.readers import idle_pct

MOVES = "classify_series_per_s"


def read(ctx):
    return idle_pct(ctx)
