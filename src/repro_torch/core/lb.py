"""DTW lower bounds: Keogh envelopes, reversed LB_Keogh, LB_Kim (PyTorch
counterpart of :mod:`repro.core.lb`).  All bounds are for *squared* DTW
cost.  Envelopes are built once around the codebook centroids at training
time (the paper's reversed LB_Keogh)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["keogh_envelope", "lb_keogh", "lb_kim", "cascade_bound",
           "lb_cascade", "lb_lut"]


def _shift(x: torch.Tensor, offset: int, fill: float) -> torch.Tensor:
    """``x[..., i + offset]`` with out-of-range slots reading ``fill``."""
    if offset == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(offset),), fill, dtype=x.dtype,
                     device=x.device)
    if offset > 0:
        return torch.cat([x[..., offset:], pad], dim=-1)
    return torch.cat([pad, x[..., :offset]], dim=-1)


def _rolling_extreme(x: torch.Tensor, w: int, combine: Callable,
                     fill: float) -> torch.Tensor:
    """``combine`` over the truncated window ``x[max(0, i-w) ..
    min(L-1, i+w)]`` by doubling: O(L log w) time, O(L) memory."""
    width = 2 * w + 1
    p = 1 << (width.bit_length() - 1)       # largest power of two <= width
    L = x.shape[-1]
    pad = torch.full(x.shape[:-1] + (w,), fill, dtype=x.dtype,
                     device=x.device)
    g = torch.cat([pad, x, pad], dim=-1)
    step = 1
    while step < p:
        g = combine(g, _shift(g, step, fill))
        step *= 2
    # window i spans pad[i .. i+width-1]; its two covering p-windows start
    # at i and i + width - p
    return combine(g[..., :L], g[..., width - p:width - p + L])


def keogh_envelope(x: torch.Tensor, window: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upper/lower Keogh envelope ``(..., L)``: rolling max/min over
    ``|shift| <= window`` (clamped to ``L - 1``)."""
    x = x.to(torch.float32)
    L = x.shape[-1]
    w = max(0, min(int(window), L - 1))
    if w == 0:
        return x, x
    upper = _rolling_extreme(x, w, torch.maximum, float("-inf"))
    lower = _rolling_extreme(x, w, torch.minimum, float("inf"))
    return upper, lower


def lb_keogh(q: torch.Tensor, upper: torch.Tensor,
             lower: torch.Tensor) -> torch.Tensor:
    """LB_Keogh(q, c) given c's envelope; broadcasts ``(..., L)``."""
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    above = torch.where(q > upper, (q - upper) ** 2, zero)
    below = torch.where(q < lower, (lower - q) ** 2, zero)
    return (above + below).sum(-1)


def lb_kim(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Simplified LB_Kim: first and last points are always aligned."""
    return (q[..., 0] - c[..., 0]) ** 2 + (q[..., -1] - c[..., -1]) ** 2


def cascade_bound(x: torch.Tensor, c: torch.Tensor, upper: torch.Tensor,
                  lower: torch.Tensor) -> torch.Tensor:
    """The cascade's bound ``max(LB_Kim(x, c), LB_Keogh(x, env(c)))``, with
    ``upper``/``lower`` the Keogh envelope of ``c``; broadcasts ``(..., L)``.
    Every cascade of the package (the encode's filter, the search bounds,
    the query tables, the plain ``lb_refine``) forms its bound here, so
    they share one summation order."""
    return torch.maximum(lb_kim(x, c), lb_keogh(x, upper, lower))


def lb_cascade(q: torch.Tensor, centroids: torch.Tensor,
               upper: torch.Tensor, lower: torch.Tensor) -> torch.Tensor:
    """``max(LB_Kim, reversed LB_Keogh)`` of ``q (L,)`` against every row of
    ``centroids (K, L)`` with its envelope ``(K, L)`` -> ``(K,)``."""
    return cascade_bound(q[None, :], centroids, upper, lower)


def lb_lut(q_segs: torch.Tensor, centroids: torch.Tensor,
           upper: torch.Tensor, lower: torch.Tensor) -> torch.Tensor:
    """Cascaded lower-bound table for the asymmetric query LUT:
    ``q_segs (..., M, S)`` vs ``centroids (M, K, S)`` with envelopes
    ``(M, K, S)`` -> ``(..., M, K)``.  Every entry lower-bounds the squared
    subspace distance of the query table, so code-wise sums of this table
    lower-bound the asymmetric ADC distance."""
    return cascade_bound(q_segs[..., None, :], centroids, upper, lower)
