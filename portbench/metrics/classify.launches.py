"""Kernel launches a classify batch, from the profiler's trace."""

from portbench.readers import per_batch

MOVES = "classify_series_per_s"


def read(ctx):
    n = per_batch(ctx)
    if n is None:
        return None
    return sum(1 for a in ctx.slice.device if a.cat == "kernel") / n
