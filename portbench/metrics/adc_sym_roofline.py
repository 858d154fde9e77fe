"""Row 3 (``kernels/pq_adc``, symmetric ADC): a batch's codes against the
training codes through the LUT, its bound from the cell's shapes over
the kernel's device time in the trace."""

from portbench import roofline
from portbench.readers import per_batch, roofline_pct

MOVES = "classify_series_per_s"


def read(ctx):
    n = per_batch(ctx)
    if n is None:
        return None
    g = ctx.geo
    bound = roofline.adc_sym(ctx.stats["n_test"], ctx.stats["n_train"],
                             g.M, g.K).bound_s() * n
    return roofline_pct(bound, ctx.slice.kernels("adc_rows_kernel",
                                                 "adc_sym_kernel"))
