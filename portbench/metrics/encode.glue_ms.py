"""Device milliseconds a classify batch spends in kernels the port did
not write by hand: the PQ glue of ``core/pq.py`` and ``core/knn.py``
(pre-alignment, the LB filter, its sort and gathers, the argmin), from
the profiler's trace."""

from portbench.readers import per_batch

MOVES = "classify_series_per_s"


def read(ctx):
    n = per_batch(ctx)
    if n is None:
        return None
    us = sum(a.dur for a in ctx.slice.device
             if a.cat == "kernel" and a.base not in ctx.hand_written)
    return us * 1e-3 / n
