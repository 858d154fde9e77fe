"""Batched LB-cascade filter-and-refine top-k search (counterpart of
:mod:`repro.core.lb_search`).

Phase 1 (bound): ``max(LB_Kim, reversed LB_Keogh)`` for every (query,
candidate) pair, computed in chunks of queries so that no ``(Nq, N, L)``
temporary exceeds :data:`BOUND_CHUNK_BYTES`.  A matching *upper* bound
seeds the thresholds: squared Euclidean distance dominates squared banded
DTW (the identity path lies inside every band), so the k-th smallest ED
per query, one float32 matrix product, upper-bounds the k-th smallest
DTW.  TF32 is off at package import; otherwise the seed would stop being
a sound upper bound.

Phase 2 (refine): the reference's ``lax.while_loop`` becomes a host loop.
Each wave takes the ``R`` lowest still-useful bounds of the whole
``(Nq, N)`` matrix (a stable sort, lower flat index first among ties, as
``lax.top_k``), sends the zipped pairs through
:func:`repro_torch.core.dispatch.lb_refine` (the ``lb_refine`` kernel on
the card, which re-checks each bound against the query's current
threshold and sweeps the band only for survivors), and tightens the
thresholds.  Thresholds, remaining bounds and verified distances stay on
the device; the loop reads one boolean per wave to the host, its exit
test: every query's smallest unprocessed bound is at or above its k-th
best verified distance, which certifies the verified top-k as exact.

Measures without the pruning capabilities (``MeasureSpec.can_prune``:
wdtw, erp, msm) take the exact dense path: one
:func:`~repro_torch.core.dispatch.elastic_cdist` plus a stable top-k.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import measures
from .dispatch import effective_window, elastic_cdist, lb_refine
from .dtw import euclidean_sq
from .lb import cascade_bound, keogh_envelope
from .measures import MeasureArg
from .topk import smallest_k

__all__ = ["filtered_topk", "cascade_bounds", "BOUND_CHUNK_BYTES"]

# Cap on one (queries, N, L) float32 temporary of the phase-1 bound; the
# LB_Keogh expression holds about five of them at once.
BOUND_CHUNK_BYTES = 256 << 20

_INF = float("inf")


def cascade_bounds(Q: torch.Tensor, X: torch.Tensor, upper: torch.Tensor,
                   lower: torch.Tensor) -> torch.Tensor:
    """``max(LB_Kim(q, x), LB_Keogh(x, env(q)))`` for every pair of
    ``Q (Nq, L)`` (envelopes ``upper``/``lower (Nq, L)``) and ``X (N, L)``
    -> ``(Nq, N)``, in chunks of queries under :data:`BOUND_CHUNK_BYTES`."""
    Nq, L = Q.shape
    N = X.shape[0]
    out = torch.empty((Nq, N), dtype=torch.float32, device=Q.device)
    rows = max(1, BOUND_CHUNK_BYTES // max(1, N * L * 4))
    for s in range(0, Nq, rows):
        e = min(Nq, s + rows)
        out[s:e] = cascade_bound(X[None, :, :], Q[s:e, None, :],
                                 upper[s:e, None, :], lower[s:e, None, :])
    return out


def _kth(d: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest value per row (values only: tie order is moot)."""
    return torch.topk(d, k, dim=1, largest=False).values[:, -1]


def _topk_ids(d: torch.Tensor, k: int):
    """Stable k smallest per row; ``-1`` ids where the distance is inf."""
    dk, idx = smallest_k(d, k)
    idx = torch.where(torch.isfinite(dk), idx, torch.full_like(idx, -1))
    return dk, idx.to(torch.int32)


def _dense_topk(Q: torch.Tensor, X: torch.Tensor, window: Optional[int],
                k: int, valid: Optional[torch.Tensor],
                q_valid: Optional[torch.Tensor], spec, with_stats: bool):
    """Exact dense fallback: one all-pairs launch + a stable top-k."""
    d = elastic_cdist(Q, X, window, measure=spec)
    n_q = (torch.tensor(Q.shape[0], device=Q.device) if q_valid is None
           else q_valid.sum())
    if valid is not None:
        d = torch.where(valid[None, :], d, _INF)
        n_ref = n_q * valid.sum()
    else:
        n_ref = n_q * X.shape[0]
    if q_valid is not None:
        d = torch.where(q_valid[:, None], d, _INF)
    dk, idx = _topk_ids(d, k)
    if with_stats:
        # no cascade ran: every valid pair was evaluated exactly, in what
        # amounts to a single wave
        return dk, idx, {"n_bounded": n_ref, "n_refined": n_ref,
                         "n_waves": torch.ones((), dtype=torch.int64,
                                               device=Q.device),
                         "refined_per_wave": n_ref[None]}
    return dk, idx, n_ref


def filtered_topk(Q: torch.Tensor, X: torch.Tensor, window: Optional[int],
                  k: int, budget: Optional[int] = None,
                  valid: Optional[torch.Tensor] = None,
                  max_iters: Optional[int] = None,
                  measure: MeasureArg = None,
                  q_valid: Optional[torch.Tensor] = None,
                  with_stats: bool = False, band: str = "static"):
    """Exact banded elastic top-k of ``Q (Nq, L)`` against ``X (N, L)``
    (tensors on one device).

    ``valid (N,)`` masks candidates (False rows are never returned);
    ``q_valid (Nq,)`` masks padding queries (all-``inf`` / ``-1`` results,
    no refine work, not counted).  Returns ``(d (Nq, k), idx (Nq, k)
    int32, n_refined)``: squared distances ascending, lower index first
    among equal distances, ``inf`` / ``-1`` past the valid candidates, and
    the number of exact elastic evaluations.  Requires ``1 <= k <= N``.

    ``with_stats=True`` swaps the third return for the pruning telemetry:
    ``n_bounded``, ``n_refined``, ``n_waves`` (device scalars) and
    ``refined_per_wave`` (per-wave counts, zero-padded to the wave cap).
    ``band="adaptive"`` is not ported (the dispatch raises).
    """
    if band not in ("static", "adaptive"):
        raise ValueError(f"unknown band mode {band!r}; "
                         "expected 'static' or 'adaptive'")
    Q = Q.to(torch.float32).contiguous()
    X = X.to(torch.float32).contiguous()
    Nq, L = Q.shape
    N = X.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"k={k} out of range: must satisfy 1 <= k <= {N}")
    spec = measures.resolve(measure)
    if not spec.can_prune:
        return _dense_topk(Q, X, window, k, valid, q_valid, spec,
                           with_stats)
    dev = Q.device
    # Per-wave budget: small waves (a few pairs per query) converge in a
    # handful of launches; the cap bounds the pruning-free worst case to
    # one exhaustive sweep.
    per_q = max(k, 4) if budget is None else max(k, int(budget))
    R = min(Nq * N, Nq * per_q)
    iters_cap = (-(-(Nq * N) // R) + 1 if max_iters is None
                 else int(max_iters))

    # envelopes around the queries, on the window=None contract
    up, lo = keogh_envelope(Q, effective_window(L, window))
    lb_rem = cascade_bounds(Q, X, up, lo)                     # (Nq, N)
    d_ub = euclidean_sq(Q, X)                                 # >= DTW
    if valid is not None:
        lb_rem = torch.where(valid[None, :], lb_rem, _INF)
        d_ub = torch.where(valid[None, :], d_ub, _INF)
    if q_valid is not None:
        lb_rem = torch.where(q_valid[:, None], lb_rem, _INF)
        d_ub = torch.where(q_valid[:, None], d_ub, _INF)
    # strict upper margin: exact ties (a query that IS a database row)
    # must still refine, so the seed sits just above the k-th smallest ED
    seed = _kth(d_ub, k) * 1.0001 + 1e-6
    del d_ub

    d_exact = torch.full((Nq, N), _INF, dtype=torch.float32, device=dev)
    thresh = seed
    n_ref = torch.zeros((), dtype=torch.int64, device=dev)
    waves = []
    while len(waves) < iters_cap and bool(
            (lb_rem.min(dim=1).values < thresh).any()):
        # the R smallest still-useful bounds; a bound at or above its
        # query's threshold keys to +inf and, picked as filler, is
        # discarded unrefined (thresholds only tighten)
        key = torch.where(lb_rem < thresh[:, None], lb_rem, _INF)
        flat = torch.sort(key.reshape(-1), stable=True).indices[:R]
        q_idx = flat // N
        c_idx = flat % N
        # filler (already processed, deleted, masked) gets a -inf
        # threshold: the cascade never beats it, its band is never swept
        fresh = torch.isfinite(lb_rem[q_idx, c_idx])
        if valid is not None:
            fresh = fresh & valid[c_idx]
        th = torch.where(fresh, thresh[q_idx], -_INF)
        d, refined = lb_refine(Q[q_idx], X[c_idx], up[q_idx], lo[q_idx], th,
                               window, measure=spec, band=band)
        refined = refined & fresh
        # (q, c) pairs are unique within a wave
        d_exact[q_idx, c_idx] = torch.minimum(
            d_exact[q_idx, c_idx], torch.where(refined, d, _INF))
        lb_rem[q_idx, c_idx] = _INF
        wave = refined.sum()
        n_ref = n_ref + wave
        waves.append(wave)
        thresh = torch.minimum(_kth(d_exact, k), seed)

    dk, idx = _topk_ids(d_exact, k)
    if not with_stats:
        return dk, idx, n_ref
    n_q = (torch.tensor(Nq, device=dev) if q_valid is None
           else q_valid.sum())
    n_cand = torch.tensor(N, device=dev) if valid is None else valid.sum()
    per_wave = torch.zeros(iters_cap, dtype=torch.int64, device=dev)
    if waves:
        per_wave[:len(waves)] = torch.stack(waves)
    return dk, idx, {"n_bounded": n_q * n_cand, "n_refined": n_ref,
                     "n_waves": torch.tensor(len(waves), device=dev),
                     "refined_per_wave": per_wave}
