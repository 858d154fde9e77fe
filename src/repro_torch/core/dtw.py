"""Elastic alignment distances in PyTorch — anti-diagonal wavefront.

Counterpart of :mod:`repro.core.dtw`.  The DP recurrence (DTW shown; the
per-move costs of every measure come from :mod:`.measures`)

    T[i, j] = min(T[i-1, j-1] + diag_cost,
                  T[i-1, j  ] + vert_cost,
                  T[i,   j-1] + horiz_cost)

is swept anti-diagonal by anti-diagonal: the reference's ``vmap`` becomes
a batch dimension of pairs and its ``scan`` a Python loop over the
``2L-1`` diagonals.  Diagonal ``d`` is held full width (indexed by ``i``,
``+inf`` outside the band) but only its Sakoe-Chiba cells
``i in [lo(d), hi(d)]`` are computed, so the work per step follows the
band.  Each cell is computed by the same float32 operations as the
reference's compiled sweep (its shared-cost cell is one fused multiply-add,
:func:`.measures.fma`), so DTW results are bit-identical to it.

This is the plain version of the ``dtw_band`` kernels: the CPU route of
:mod:`.dispatch`, and what ``chip_smoke.py`` holds the kernels against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import measures
from .measures import MeasureArg

__all__ = ["dtw_pair", "dtw_batch", "dtw_cdist", "dtw_full_table",
           "euclidean_sq"]

_INF = float("inf")


def _band(d: int, L: int, w: int) -> Tuple[int, int]:
    """Rows ``[lo, hi]`` of anti-diagonal ``d`` inside the band."""
    lo = max(0, d - (L - 1), -((w - d) // 2))
    hi = min(L - 1, d, (d + w) // 2)
    return lo, hi


def _diag_sweep(A: torch.Tensor, B: torch.Tensor, window: Optional[int],
                return_table: bool, measure: MeasureArg = None):
    """Batched sweep over zipped pairs ``A (P, L)``, ``B (P, L)``.

    Returns the final costs ``(P,)`` and, with ``return_table``, the stack
    of diagonals ``(2L-1, P, L)`` where ``table[d, p, i] == T_p[i, d-i]``
    (used by DBA backtracking).
    """
    spec = measures.resolve(measure)
    A = A.to(torch.float32)
    B = B.to(torch.float32)
    P, L = A.shape
    w = L if window is None else int(window)
    dev = A.device
    inf_col = torch.full((P, 1), _INF, dtype=torch.float32, device=dev)
    if spec.uses_neighbors:
        # a_{i-1} / b_{j-1} with element 0 as the sentinel at the border
        A_prev = torch.cat([A[:, :1], A[:, :-1]], dim=1)
        B_prev = torch.cat([B[:, :1], B[:, :-1]], dim=1)
    if spec.uses_gap_border:
        # virtual first column/row: T[i, -1] = ga[i], T[-1, j] = gb[j]
        ga = torch.cumsum(measures.gap_costs(spec, A), dim=1)
        gb = torch.cumsum(measures.gap_costs(spec, B), dim=1)

    prev1 = torch.full((P, L), _INF, dtype=torch.float32, device=dev)
    prev2 = prev1
    table = []
    for d in range(2 * L - 1):
        lo, hi = _band(d, L, w)
        diag = torch.full((P, L), _INF, dtype=torch.float32, device=dev)
        if lo <= hi:
            i_idx = torch.arange(lo, hi + 1, device=dev)
            j_idx = d - i_idx
            x = A[:, lo:hi + 1]
            y = B[:, j_idx]
            xp = A_prev[:, lo:hi + 1] if spec.uses_neighbors else None
            yp = B_prev[:, j_idx] if spec.uses_neighbors else None
            dd = (i_idx - j_idx).abs() if spec.uses_position else None
            factors = measures.cost_factors(spec, x, y, dd, L)
            if factors is None:
                c_d, c_v, c_h = measures.move_costs(spec, x, y, xp, yp, dd,
                                                    L)

            pred_h = prev1[:, lo:hi + 1]                    # T[i, j-1]
            if lo == 0:
                pred_v = torch.cat([inf_col, prev1[:, :hi]], dim=1)
                pred_d = torch.cat([inf_col, prev2[:, :hi]], dim=1)
            else:
                pred_v = prev1[:, lo - 1:hi]                # T[i-1, j]
                pred_d = prev2[:, lo - 1:hi]                # T[i-1, j-1]
            at_i0, at_j0 = lo == 0, hi == d   # column 0 is i=0; last is j=0
            if spec.uses_gap_border or at_i0 and at_j0:
                pred_v, pred_d, pred_h = (pred_v.clone(), pred_d.clone(),
                                          pred_h.clone())
            if spec.uses_gap_border:
                if at_j0:
                    pred_h[:, -1] = ga[:, d]
                    if d >= 1:
                        pred_d[:, -1] = ga[:, d - 1]
                if at_i0:
                    pred_v[:, 0] = gb[:, d]
                    if d >= 1:
                        pred_d[:, 0] = gb[:, d - 1]
            if d == 0:
                # Base case: cell (0, 0) starts from 0 via the diagonal move.
                pred_d[:, 0] = 0.0
            if factors is not None:   # shared-cost family (DTW, WDTW)
                cell = measures.fma(*factors, torch.minimum(
                    torch.minimum(pred_d, pred_h), pred_v))
            else:
                cell = torch.minimum(torch.minimum(pred_d + c_d,
                                                   pred_v + c_v),
                                     pred_h + c_h)
            diag[:, lo:hi + 1] = cell
        if return_table:
            table.append(diag)
        prev1, prev2 = diag, prev1
    final = prev1[:, L - 1]
    return final, (torch.stack(table) if return_table else None)


def dtw_pair(a: torch.Tensor, b: torch.Tensor, window: Optional[int] = None,
             measure: MeasureArg = None) -> torch.Tensor:
    """Elastic cost between two equal-length 1-D series (scalar tensor)."""
    return _diag_sweep(a[None], b[None], window, False, measure)[0][0]


def dtw_batch(A: torch.Tensor, B: torch.Tensor, window: Optional[int] = None,
              measure: MeasureArg = None) -> torch.Tensor:
    """Pairwise elastic cost over zipped batches: ``A (N, L)``, ``B (N, L)``
    -> ``(N,)``."""
    return _diag_sweep(A, B, window, False, measure)[0]


def dtw_cdist(A: torch.Tensor, B: torch.Tensor, window: Optional[int] = None,
              block: int = 1 << 18, measure: MeasureArg = None
              ) -> torch.Tensor:
    """All-pairs elastic cost: ``A (N, L)``, ``B (M, L)`` -> ``(N, M)``.

    Sweeps whole rows of ``A`` against all of ``B`` in blocks of about
    ``block`` pairs, so nothing of size ``N * M * L`` is materialised.
    """
    N, L = A.shape
    M = B.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=A.device)
    rows = max(1, block // max(M, 1))
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        aa = A[r0:r1].repeat_interleave(M, dim=0)
        bb = B.repeat(r1 - r0, 1)
        out[r0:r1] = dtw_batch(aa, bb, window, measure).view(r1 - r0, M)
    return out


def dtw_full_table(a: torch.Tensor, b: torch.Tensor,
                   window: Optional[int] = None) -> torch.Tensor:
    """DTW table in diagonal layout: ``table[i + j, ..., i] == dtw[i, j]``.

    ``a``/``b`` are ``(L,)`` (-> ``(2L-1, L)``) or zipped ``(P, L)``
    (-> ``(2L-1, P, L)``).  DTW only: used by DBA to backtrack paths.
    """
    if a.dim() == 1:
        return _diag_sweep(a[None], b[None], window, True)[1][:, 0]
    return _diag_sweep(a, b, window, True)[1]


def euclidean_sq(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """All-pairs squared Euclidean distance (lock-step baseline).  TF32 is
    off at package import, so the product runs in full float32."""
    a2 = (A * A).sum(-1)[:, None]
    b2 = (B * B).sum(-1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * A @ B.T, min=0.0)
