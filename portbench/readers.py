"""Helpers the per-layer readers (``portbench/metrics/*.py``) share.

A reader gets a context with ``slice`` (the traced slice, or None),
``stats`` (the entry's counts: batches in the slice, the step's work,
the batches and seconds before the profiler started), ``geo``, ``config``
and ``hand_written`` (the names of the program's CUDA kernels).  A reader
that finds nothing to read returns None, and the metric is left out.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["per_batch", "roofline_pct", "idle_pct"]


def per_batch(ctx) -> Optional[int]:
    """Whole batches inside the traced slice, or None."""
    n = ctx.stats.get("slice_batches", 0)
    return n if ctx.slice is not None and n > 0 else None


def roofline_pct(bound_s: float, kernels) -> Optional[float]:
    """The bound's share of the kernels' device time, in percent."""
    t = sum(a.dur for a in kernels) * 1e-6
    return 100.0 * bound_s / t if t > 0 else None


def idle_pct(ctx) -> Optional[float]:
    s = ctx.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
