"""Plain PyTorch versions of the ``lb_refine`` kernel (counterpart of
:func:`repro.kernels.lb_cascade.ref.lb_refine_ref`): the cascade bound from
the :mod:`repro_torch.core.lb` helpers, the exact banded cost of EVERY pair
from the plain sweep (inside its corridor where one is given), then a
select.  The kernel's pruning (a pruned pair never sweeps its band) is a
speed-up, not a difference in results.

And of the encode's LB filter (``lb_filter_topk_kernel``), which has no
Pallas counterpart: the bounds of every segment against every centroid of
its subspace, a subspace at a time, then a stable sort of all K."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.dtw import dtw_batch
from ...core.lb import cascade_bound
from ...core.measures import MeasureArg
from ..dtw_band.ref import dtw_band_adaptive_ref

__all__ = ["lb_refine_ref", "filter_bounds", "lb_filter_ref",
           "undecided_ranks"]


def lb_refine_ref(A: torch.Tensor, B: torch.Tensor, upper: torch.Tensor,
                  lower: torch.Tensor, thresh: torch.Tensor,
                  window: Optional[int] = None,
                  measure: MeasureArg = None, corridor=None,
                  width: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    lb = cascade_bound(B, A, upper, lower)      # LB_Keogh(b, env(a))
    if corridor is None:
        d = dtw_batch(A, B, window, measure)
    else:
        d = dtw_band_adaptive_ref(A, B, *corridor, window, width, measure)
    surv = lb < thresh
    return torch.where(surv, d, lb), surv


def filter_bounds(segs: torch.Tensor, centroids: torch.Tensor,
                  upper: torch.Tensor, lower: torch.Tensor) -> torch.Tensor:
    """The cascade bound of every segment ``segs (N, M, S)`` against every
    centroid of its subspace, ``centroids (M, K, S)`` with their Keogh
    envelopes, a subspace at a time: ``(N, M, K)``."""
    return torch.stack([
        cascade_bound(segs[:, m, None, :], centroids[m][None],
                      upper[m][None], lower[m][None])
        for m in range(segs.shape[1])], dim=1)


def lb_filter_ref(segs: torch.Tensor, centroids: torch.Tensor,
                  upper: torch.Tensor, lower: torch.Tensor, refine_t: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``segs (N, M, S)`` against ``centroids (M, K, S)`` with their Keogh
    envelopes: the ``refine_t`` centroids of smallest cascade bound per
    (series, subspace), lower index first among equal bounds (a stable
    sort, as ``jax.lax.top_k``), and the smallest bound left out.
    Returns ``(cand (N, M, T) int64, next_lb (N, M))``."""
    T = refine_t
    lbs = filter_bounds(segs, centroids, upper, lower)        # (N, M, K)
    srt = torch.sort(lbs, dim=-1, stable=True)
    return srt.indices[..., :T], srt.values[..., T]


def undecided_ranks(bounds: torch.Tensor, exact: torch.Tensor,
                    refine_t: int, rtol: float) -> torch.Tensor:
    """``(N, M, T)``: the ranks below ``T = refine_t`` of the stable order
    of ``bounds (N, M, K)`` whose neighbour in that order lies within
    ``rtol`` relative and is not the same bound in ``exact`` (the bounds
    in float64).  There a bound summed in another order may take the
    other place, so the filter's candidates may differ; everywhere else,
    ties of equal exact bounds included, they must not."""
    srt = torch.sort(bounds, dim=-1, stable=True)
    v = srt.values[..., :refine_t + 1]
    e = exact.gather(-1, srt.indices[..., :refine_t + 1])
    gap = v[..., 1:] - v[..., :-1]
    close = (gap <= rtol * v[..., 1:].abs()) & (e[..., 1:] != e[..., :-1])
    out = close.clone()
    out[..., 1:] |= close[..., :-1]
    return out
