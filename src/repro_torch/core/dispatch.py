"""Dispatch for every elastic / ADC hot path of the port (counterpart of
:mod:`repro.core.dispatch`, with the reference's op names):

    elastic_pairwise(A, B, window)   zipped pairs          -> (N,)
    elastic_cdist(A, B, window)      all pairs             -> (N, M)
    adc_cdist(codes_a, codes_b, lut) symmetric ADC         -> (Na, Nb)
    adc_lookup(codes, qlut)          asymmetric scan       -> (N,) / (Nq, N)
    prealign_encode(X, centroids)    fused MODWT prealign
                                     + elastic-1NN encode  -> (N, M) codes
    lb_refine(A, B, up, lo, thresh)  fused LB cascade +
                                     conditional DTW refine -> (N,), (N,)
    two_level_coarse(Q, top, coarse, child_idx, child_valid)
                                     hierarchical coarse
                                     rank + child fan-out  -> (Nq, n_lists)

The route follows the tensors' device, with no environment variable:
CUDA tensors launch the hand-written kernels (route ``"cuda"``), CPU
tensors take their plain PyTorch versions (route ``"torch"``).  The
:data:`stats` / :data:`totals` ledgers count ``(op, route)`` and, for
measure-parameterised ops, ``(op[measure], route)`` per call;
:func:`reset_stats` clears :data:`stats` only.  Every count is mirrored
into the observability registry as a persistent ``dispatch_total``
counter labeled ``kind="call"``: the port runs eagerly and counts each
call, where the reference counts each *trace* (``kind="trace"``).

Not ported yet (later slices): ``band="adaptive"`` (the adaptive
corridors of ``elastic_pairwise`` and ``lb_refine``) and quantised LUTs
(``lut_dtype != "float32"``).

Window contract: ``window=None`` means unbanded, i.e. a band of ``L - 1``;
:func:`effective_window` clamps every materialised window to
``[0, L - 1]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..obs import registry as _obs_registry
from . import measures
from .measures import MeasureArg, MeasureSpec
from .topk import smallest_k

__all__ = [
    "elastic_pairwise", "elastic_cdist", "adc_cdist", "adc_lookup",
    "prealign_encode", "lb_refine", "two_level_coarse", "stats", "totals",
    "reset_stats", "effective_window",
]

stats: Dict[Tuple[str, str], int] = {}
totals: Dict[Tuple[str, str], int] = {}


def effective_window(length: int, window: Optional[int]) -> int:
    """``None`` -> ``length - 1``; everything clamped to ``[0, length-1]``.

    >>> effective_window(128, None), effective_window(128, 500)
    (127, 127)
    """
    w = length - 1 if window is None else int(window)
    return max(0, min(w, length - 1))


def reset_stats() -> None:
    """Clear the per-run :data:`stats` ledger (:data:`totals` stays)."""
    stats.clear()


def _route(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "torch"


def _count(op: str, route: str,
           measure: Optional[MeasureSpec] = None) -> None:
    keys = [(op, route)]
    if measure is not None:
        keys.append((f"{op}[{measure.name}]", route))
    for key in keys:
        stats[key] = stats.get(key, 0) + 1
        totals[key] = totals.get(key, 0) + 1
    labels = {"op": op, "backend": route, "kind": "call"}
    if measure is not None:
        labels["measure"] = measure.name
    _obs_registry.REGISTRY.counter("dispatch_total", persistent=True,
                                   **labels).inc()


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


def elastic_pairwise(A: torch.Tensor, B: torch.Tensor,
                     window: Optional[int] = None, *,
                     measure: MeasureArg = None,
                     band: str = "static") -> torch.Tensor:
    """Elastic cost over zipped pairs: ``(N, L) x (N, L) -> (N,)``."""
    from ..kernels.dtw_band.ops import dtw_band
    if band != "static":
        raise _not_ported(f"band={band!r}")
    spec = measures.resolve(measure)
    _count("elastic_pairwise", _route(A), spec)
    return dtw_band(A, B, window, spec)


def elastic_cdist(A: torch.Tensor, B: torch.Tensor,
                  window: Optional[int] = None, *,
                  measure: MeasureArg = None) -> torch.Tensor:
    """All-pairs elastic cost: ``(N, L) x (M, L) -> (N, M)``."""
    from ..kernels.dtw_band.ops import dtw_band_cdist
    spec = measures.resolve(measure)
    _count("elastic_cdist", _route(A), spec)
    return dtw_band_cdist(A, B, window, spec)


def adc_cdist(codes_a: torch.Tensor, codes_b: torch.Tensor,
              lut: torch.Tensor, *,
              lut_dtype: str = "float32") -> torch.Tensor:
    """Symmetric PQ distance matrix ``sqrt(sum_m LUT[m, a^m, b^m])``."""
    from ..kernels.pq_adc.ops import adc_sym_cdist
    if lut_dtype != "float32":
        raise _not_ported(f"lut_dtype={lut_dtype!r}")
    _count("adc_cdist", _route(lut))
    return adc_sym_cdist(codes_a, codes_b, lut)


def adc_lookup(codes: torch.Tensor, qlut: torch.Tensor, *,
               lut_dtype: str = "float32") -> torch.Tensor:
    """Asymmetric ADC scan: ``codes (N, M)`` against ``qlut (M, K)`` ->
    ``(N,)``, or against ``(Nq, M, K)`` query tables -> ``(Nq, N)``."""
    from ..kernels.pq_adc.ops import adc_lookup as _adc_lookup
    if lut_dtype != "float32":
        raise _not_ported(f"lut_dtype={lut_dtype!r}")
    _count("adc_lookup", _route(qlut))
    return _adc_lookup(codes, qlut)


def prealign_encode(X: torch.Tensor, centroids: torch.Tensor, *,
                    level: int, tail: int, window: Optional[int] = None,
                    measure: MeasureArg = None) -> torch.Tensor:
    """Fused MODWT prealign + exact elastic-1NN encode: ``X (N, D)``
    against ``centroids (M, K, S)`` -> codes ``(N, M)`` int32."""
    from ..kernels.prealign_encode.ops import (
        prealign_encode as _prealign_encode)
    spec = measures.resolve(measure)
    _count("prealign_encode", _route(X), spec)
    return _prealign_encode(X, centroids, level, tail, window, spec)


def lb_refine(A: torch.Tensor, B: torch.Tensor, upper: torch.Tensor,
              lower: torch.Tensor, thresh: torch.Tensor,
              window: Optional[int] = None, *,
              measure: MeasureArg = None,
              band: str = "static") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cascade bound + conditional banded refine over zipped pairs:
    ``A (N, L)`` queries, ``B (N, L)`` candidates, ``upper``/``lower
    (N, L)`` Keogh envelopes of ``A``, ``thresh (N,)``.

    Returns ``(d (N,), refined (N,) bool)``: ``d`` is the exact banded
    elastic cost where ``max(LB_Kim, LB_Keogh) < thresh`` and the (valid)
    lower bound elsewhere.  On the card a pruned pair never sweeps its
    band.  Only sound for measures with ``has_keogh_lb`` (a hard error
    otherwise: :func:`repro_torch.core.lb_search.filtered_topk` takes the
    exact dense path for them before reaching here).

    >>> A, B = torch.zeros(2, 8), torch.ones(2, 8)
    >>> env = torch.zeros(2, 8)                    # degenerate envelopes
    >>> d, refined = lb_refine(A, B, env, env, torch.tensor([100.0, 0.0]),
    ...                        window=2)
    >>> refined.tolist(), float(d[0])              # row 1 pruned by bound
    ([True, False], 8.0)
    """
    from ..kernels.lb_cascade.ops import lb_refine as _lb_refine
    spec = measures.resolve(measure)
    if not spec.has_keogh_lb:
        raise ValueError(
            f"measure {spec.name!r} has no sound Keogh/Kim lower bound; "
            "lb_refine would prune incorrectly — use the exact dense path")
    if band == "adaptive":
        raise _not_ported("band='adaptive'")
    if band != "static":
        raise ValueError(f"unknown band mode {band!r}; "
                         "expected 'static' or 'adaptive'")
    _count("lb_refine", _route(A), spec)
    return _lb_refine(A, B, upper, lower, thresh, window, spec)


def two_level_coarse(Q: torch.Tensor, top: torch.Tensor,
                     coarse: torch.Tensor, child_idx: torch.Tensor,
                     child_valid: torch.Tensor,
                     window: Optional[int] = None, *, n_probe_top: int,
                     measure: MeasureArg = None) -> torch.Tensor:
    """Hierarchical (two-level) coarse stage for large ``n_lists``.

    ``Q (Nq, D)`` is ranked against the ``top (n_top, D)`` quantizer (one
    all-pairs launch); only the children of each query's ``n_probe_top``
    nearest top cells — ``child_idx`` / ``child_valid (n_top,
    max_children)`` into ``coarse (n_lists, D)`` — are evaluated exactly,
    as one zipped-pairs launch.  Returns ``(Nq, n_lists)`` coarse
    distances, ``+inf`` for lists outside the fan-out.  With
    ``n_probe_top == n_top`` every list is visited and the result equals
    the flat coarse cdist.

    >>> coarse = torch.arange(4, dtype=torch.float32)[:, None] * torch.ones(8)
    >>> top = torch.tensor([[0.5] * 8, [2.5] * 8])  # parents of {0,1}, {2,3}
    >>> child_idx = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    >>> dc = two_level_coarse(torch.zeros(1, 8), top, coarse, child_idx,
    ...                       torch.ones(2, 2, dtype=torch.bool),
    ...                       n_probe_top=1)
    >>> torch.isfinite(dc[0]).tolist(), float(dc[0, 0])
    ([True, True, False, False], 0.0)
    """
    n_top, C = child_idx.shape
    if not 1 <= n_probe_top <= n_top:
        raise ValueError(
            f"n_probe_top={n_probe_top} out of range: must satisfy "
            f"1 <= n_probe_top <= n_top={n_top}")
    spec = measures.resolve(measure)
    Q = Q.to(torch.float32)
    _count("two_level_coarse", _route(Q), spec)
    Nq = Q.shape[0]
    n_lists = coarse.shape[0]
    dc_top = elastic_cdist(Q, top, window, measure=spec)
    _, tops = smallest_k(dc_top, n_probe_top)
    child_idx = child_idx.long()
    cand = child_idx[tops].reshape(Nq, n_probe_top * C)
    cvalid = child_valid[tops].reshape(Nq, n_probe_top * C)
    cents = coarse[cand.reshape(-1)]
    qq = Q.repeat_interleave(n_probe_top * C, dim=0)
    d = elastic_pairwise(qq, cents, window, measure=spec)
    d = torch.where(cvalid.reshape(-1), d,
                    torch.full_like(d, float("inf"))).reshape(Nq, -1)
    dc = torch.full((Nq, n_lists), float("inf"), dtype=torch.float32,
                    device=Q.device)
    # scatter-min: a list reachable through two probed tops keeps one
    # (identical) distance; masked padding lanes are +inf no-ops
    return dc.scatter_reduce(1, cand, d, reduce="amin")
