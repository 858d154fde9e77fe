"""The whole classify step's share of the chip's peak: the least time the
configuration's work could take on the chip (portbench/roofline.py,
``classify_step``) times the batches done, over the wall time they took,
in the part of the window before the profiler starts."""

MOVES = "classify_series_per_s"


def read(ctx):
    n, t = ctx.stats.get("plain_batches"), ctx.stats.get("plain_s")
    if not n or not t:
        return None
    return 100.0 * ctx.stats["step"].bound_s() * n / t
