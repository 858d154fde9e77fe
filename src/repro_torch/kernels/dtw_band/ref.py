"""Plain PyTorch versions of the ``dtw_band`` kernels: the batched
anti-diagonal sweep of :mod:`repro_torch.core.dtw` for the static band,
and the corridor sweep of the reference's ``wavefront_compressed`` for
the adaptive one."""

from __future__ import annotations

from typing import Optional

import torch

from ...core import measures
from ...core.dtw import dtw_batch, dtw_cdist
from ...core.measures import MeasureArg

__all__ = ["dtw_band_ref", "dtw_band_cdist_ref", "dtw_band_adaptive_ref",
           "prefix_sum"]

INF_STANDIN = 3.0e38  # the reference's finite +inf of the compressed sweep


def dtw_band_ref(A: torch.Tensor, B: torch.Tensor,
                 window: Optional[int] = None,
                 measure: MeasureArg = None) -> torch.Tensor:
    return dtw_batch(A, B, window, measure)


def dtw_band_cdist_ref(A: torch.Tensor, B: torch.Tensor,
                       window: Optional[int] = None,
                       measure: MeasureArg = None) -> torch.Tensor:
    return dtw_cdist(A, B, window, measure=measure)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 1 in the reference kernel's order: a
    log-depth scan of shifted adds (``_prefix_sum``), not a running sum."""
    L = x.shape[1]
    t = torch.arange(L, device=x.device)[None, :]
    shift = 1
    while shift < L:
        x = x + torch.where(t >= shift, torch.roll(x, shift, dims=1), 0.0)
        shift *= 2
    return x


def dtw_band_adaptive_ref(A: torch.Tensor, B: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor,
                          window: Optional[int], width: int,
                          measure: MeasureArg = None) -> torch.Tensor:
    """Elastic cost of zipped pairs ``A, B (N, L)`` inside per-pair
    corridors ``lo, hi (N, 2L-1)`` -> ``(N,)``.

    Diagonal ``d`` holds ``width`` slots; slot ``t`` is cell
    ``i = lo[d] + t`` and is live iff ``t <= hi[d] - lo[d]``.  Its
    predecessors sit at slots shifted by the base drift
    ``s1 = lo[d] - lo[d-1]`` (horizontal at ``t + s1``, vertical at
    ``t + s1 - 1``, on ``d-1``) and ``s2 = lo[d] - lo[d-2] - 1`` (diagonal
    at ``t + s2``, on ``d-2``); a shift reads one slot at most (its sign),
    and a slot outside ``[0, width)`` reads +inf.  ``+inf`` is the finite
    ``3e38``, clamped after every cell.  ``window`` is unused: the corridor
    already lies inside the band.
    """
    del window
    spec = measures.resolve(measure)
    A = A.to(torch.float32)
    B = B.to(torch.float32)
    N, L = A.shape
    W = int(width)
    dev = A.device
    lo = lo.to(device=dev, dtype=torch.int64)
    hi = hi.to(device=dev, dtype=torch.int64)
    inf = torch.tensor(INF_STANDIN, dtype=torch.float32, device=dev)
    t = torch.arange(W, device=dev)[None, :]
    pad = torch.zeros((N, W), dtype=torch.float32, device=dev)

    def padded(x):             # values read at lo + t
        return torch.cat([x, pad], dim=1)

    def padded_rev(x):         # values read at L-1-d+lo + t: x[d - i]
        return torch.cat([x.flip(1), pad], dim=1)

    a_pad, b_rev_pad = padded(A), padded_rev(B)
    if spec.uses_neighbors:
        # a_{i-1} / b_{j-1} with element 0 as the sentinel at the border
        a_prev_pad = padded(torch.cat([A[:, :1], A[:, :-1]], dim=1))
        b_prev_rev_pad = padded_rev(torch.cat([B[:, :1], B[:, :-1]], dim=1))
    if spec.uses_gap_border:
        # virtual first column/row: T[i, -1] = ga[i], T[-1, j] = gb[j]
        ga = prefix_sum(measures.gap_costs(spec, A))
        gb = prefix_sum(measures.gap_costs(spec, B))
        zero = torch.zeros((N, 1), dtype=torch.float32, device=dev)
        ga_pad = padded(ga)
        ga_prev_pad = padded(torch.cat([zero, ga[:, :-1]], dim=1))
        gb_rev_pad = padded_rev(gb)
        gb_prev_rev_pad = padded_rev(torch.cat([zero, gb[:, :-1]], dim=1))
    inf_col = torch.full((N, 1), INF_STANDIN, dtype=torch.float32,
                         device=dev)

    def read(reg, s):
        """``reg[t + sign(s)]``, +inf outside the slots."""
        reg = torch.cat([inf_col, reg, inf_col], dim=1)
        return reg.gather(1, (t + s.clamp(-1, 1) + 1).expand(N, W))

    prev1 = torch.full((N, W), INF_STANDIN, dtype=torch.float32, device=dev)
    prev2 = prev1
    for d in range(2 * L - 1):
        lo_d = lo[:, d:d + 1]
        s1 = lo_d - lo[:, max(d - 1, 0)][:, None]
        s2 = lo_d - lo[:, max(d - 2, 0)][:, None] - 1
        ia = (lo_d + t).expand(N, W)
        ib = (L - 1 - d + lo_d + t).expand(N, W)
        x = a_pad.gather(1, ia)
        y = b_rev_pad.gather(1, ib)
        xp = a_prev_pad.gather(1, ia) if spec.uses_neighbors else None
        yp = b_prev_rev_pad.gather(1, ib) if spec.uses_neighbors else None
        i_arr = lo_d + t
        dd = (2 * i_arr - d).abs() if spec.uses_position else None
        pred_h = read(prev1, s1)
        pred_v = read(prev1, s1 - 1)
        pred_d = read(prev2, s2)
        is_i0 = i_arr == 0
        is_j0 = (d - i_arr) == 0
        if spec.uses_gap_border:
            pred_d = torch.where(is_i0, gb_prev_rev_pad.gather(1, ib),
                                 torch.where(is_j0,
                                             ga_prev_pad.gather(1, ia),
                                             pred_d))
            pred_v = torch.where(is_i0, gb_rev_pad.gather(1, ib), pred_v)
            pred_h = torch.where(is_j0, ga_pad.gather(1, ia), pred_h)
        # base case: cell (0, 0) starts from 0 via the diagonal move
        pred_d = torch.where(is_i0 & is_j0, 0.0, pred_d)
        factors = measures.cost_factors(spec, x, y, dd, L)
        if factors is not None:   # shared-cost family (DTW, WDTW)
            cell = measures.fma(*factors, torch.minimum(
                torch.minimum(pred_d, pred_h), pred_v))
        else:
            c_d, c_v, c_h = measures.move_costs(spec, x, y, xp, yp, dd, L)
            cell = torch.minimum(torch.minimum(pred_d + c_d, pred_v + c_v),
                                 pred_h + c_h)
        live = t <= hi[:, d:d + 1] - lo_d
        diag = torch.minimum(torch.where(live, cell, inf), inf)
        prev1, prev2 = diag, prev1
    # diagonal 2L-2 has lo = L-1: cell (L-1, L-1) sits in slot 0
    return prev1[:, 0]
