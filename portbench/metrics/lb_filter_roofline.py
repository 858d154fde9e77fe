"""``kernels/lb_cascade``, the encode's LB filter: the bounds of every
segment against every centroid of its subspace and their stable
top-(T+1), its bound from the cell's shapes over the kernel's device time
in the trace.  A program without the kernel reads nothing."""

from portbench import roofline
from portbench.readers import per_batch, roofline_pct

MOVES = "classify_series_per_s"


def read(ctx):
    n = per_batch(ctx)
    if n is None:
        return None
    g = ctx.geo
    bound = roofline.lb_filter(ctx.stats["n_test"], g.M, g.K,
                               g.S).bound_s() * n
    return roofline_pct(bound, ctx.slice.kernels("lb_filter"))
