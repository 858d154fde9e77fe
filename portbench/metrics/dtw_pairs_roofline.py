"""Row 1 (``kernels/dtw_band``, zipped pairs): the encode's refine of
N x M x T pairs a batch, its bound from the cell's shapes over the
kernel's device time in the trace."""

from portbench import roofline
from portbench.readers import per_batch, roofline_pct

MOVES = "classify_series_per_s"


def read(ctx):
    n = per_batch(ctx)
    if n is None:
        return None
    g = ctx.geo
    bound = roofline.dtw_pairs(ctx.stats["n_test"], g.M, g.K, g.refine_t,
                               g.S, g.window).bound_s() * n
    return roofline_pct(bound, ctx.slice.kernels("dtw_band_pairs"))
